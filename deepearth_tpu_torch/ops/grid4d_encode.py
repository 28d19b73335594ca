"""A Grid4D encoder's hash encode: every table, times its masks,
concatenated and cast to the compute dtype.

Counterpart of the hash-mode body of ``deepearth_tpu/models/grid4d.py``
``Grid4DEncoder.__call__`` up to ``combined`` (:53-84): the spatial table on
(x, y, z), the temporal table on t, and with ``use_decompositions`` the xyt,
yzt and xzt tables; a table's features are multiplied by its mask (the
spatial mask, the temporal mask, or both for the decompositions), and the
concatenation is cast once to the compute dtype. Under ``jit`` XLA fuses all
of it into the gathers; here it is one kernel launch.

:func:`grid4d_encode` routes by the config alone
(``kernels.grid4d_encode_route``: F = 2, D <= 4, an fp32 or bf16 compute
dtype, every Grid4D configuration). On that route it is a
``torch.autograd.Function``, differentiable in the tables only, that
dispatches on the device of its input: for a CUDA tensor the forward is one
launch of K2-fwd (``kernels.grid4d_encode_fwd``, ``csrc/grid4d_encode.cu``)
and each table's gradient one call of K2-bwd (``kernels.hash_encode_bwd``);
for a CPU tensor their plain versions, :func:`grid4d_encode_plain` and
``hash_encoding.hash_encode_bwd_plain``. Off that route each table goes
through ``hash_encoding.hash_encode`` (the per-table K2-fwd on the card)
with the masks, the concatenation and the cast as torch operations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import kernels
from . import hash_encoding

# (name, xyzt columns, mask bits) of each table, in the order of the output
# columns; bit 1: times spatial_mask, bit 2: times temporal_mask
TABLES = (("spatial", (0, 1, 2), 1), ("temporal", (3,), 2),
          ("xyt", (0, 1, 3), 3), ("yzt", (1, 2, 3), 3), ("xzt", (0, 2, 3), 3))
# the spacetime decompositions' coordinate columns
DECOMPOSITIONS = {name: cols for name, cols, _ in TABLES[2:]}


def _columns(xyzt: torch.Tensor, cols) -> torch.Tensor:
    """The (B, len(cols)) coordinates of a table (a stack of column views:
    no index tensor to copy to the device, so it runs in a CUDA graph)."""
    return torch.stack([xyzt[:, c] for c in cols], dim=-1)


def _mask(bits: int, spatial_mask: Optional[torch.Tensor],
          temporal_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The (N,) bool mask a table's features are multiplied by, or None.
    The decompositions take spatial & temporal, a missing one all True."""
    spatial = spatial_mask if bits & 1 else None
    temporal = temporal_mask if bits & 2 else None
    if spatial is None or temporal is None:
        return temporal if spatial is None else spatial
    return spatial & temporal


def _compose(encode, xyzt, tables, resolutions, cfgs, spatial_mask,
             temporal_mask, out_dtype) -> torch.Tensor:
    """Each table through ``encode`` (a ``hash_encode``), times its mask in
    fp32, concatenated, cast once to ``out_dtype``."""
    feats = []
    for (_, cols, bits), t, res, cfg in zip(TABLES, tables, resolutions,
                                            cfgs):
        f = encode(_columns(xyzt, cols), t, res,
                   interpolation=cfg.interpolation,
                   table_size=cfg.hash_table_size)
        mask = _mask(bits, spatial_mask, temporal_mask)
        feats.append(f if mask is None else f * mask[:, None].to(f.dtype))
    return torch.cat(feats, dim=-1).to(out_dtype)


def grid4d_encode_plain(xyzt: torch.Tensor, tables: Sequence[torch.Tensor],
                        resolutions: Sequence[torch.Tensor], cfgs,
                        spatial_mask: Optional[torch.Tensor] = None,
                        temporal_mask: Optional[torch.Tensor] = None, *,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of K2-fwd's Grid4D encode (any device): each
    table through ``hash_encode_plain``, the mask multiplies, ``cat``, one
    cast. Arguments as :func:`grid4d_encode`."""
    return _compose(hash_encoding.hash_encode_plain, xyzt, tables,
                    resolutions, cfgs, spatial_mask, temporal_mask, out_dtype)


class _Grid4DEncode(torch.autograd.Function):
    """(K2-fwd's Grid4D encode, K2-bwd per table) for CUDA tensors, their
    plain versions for CPU tensors; differentiable in the tables only."""

    @staticmethod
    def forward(ctx, xyzt, spatial_mask, temporal_mask, resolutions, cfgs,
                out_dtype, *tables):
        ctx.save_for_backward(xyzt, spatial_mask, temporal_mask, *resolutions)
        ctx.cfgs = cfgs
        ctx.tables_meta = [(tuple(t.shape), t.dtype) for t in tables]
        if xyzt.device.type == "cpu":
            return grid4d_encode_plain(xyzt, tables, resolutions, cfgs,
                                       spatial_mask, temporal_mask,
                                       out_dtype=out_dtype)
        return kernels.grid4d_encode_fwd(
            xyzt, [(t, res, cfg.hash_table_size,
                    cfg.interpolation == "linear", cols, bits)
                   for (_, cols, bits), t, res, cfg in zip(
                       TABLES, tables, resolutions, cfgs)],
            spatial_mask, temporal_mask, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        xyzt, spatial_mask, temporal_mask, *resolutions = ctx.saved_tensors
        # the cast's gradient widens to fp32, the concatenation's splits it,
        # each mask multiply's multiplies it by the mask
        grad = grad.to(torch.float32)
        grads, col = [], 0
        for (_, cols, bits), res, cfg, (shape, dtype) in zip(
                TABLES, resolutions, ctx.cfgs, ctx.tables_meta):
            width = shape[0] * shape[2]
            g = grad[:, col:col + width]
            col += width
            mask = _mask(bits, spatial_mask, temporal_mask)
            if mask is not None:
                g = g * mask[:, None].to(g.dtype)
            coords = _columns(xyzt, cols)
            if xyzt.device.type == "cpu":
                t_grad = hash_encoding.hash_encode_bwd_plain(
                    coords, g, res, shape, interpolation=cfg.interpolation,
                    table_size=cfg.hash_table_size)
            else:
                t_grad = kernels.hash_encode_bwd(
                    coords, g, res, shape, cfg.hash_table_size,
                    cfg.interpolation == "linear")
            grads.append(t_grad.to(dtype))
        return (None,) * 6 + tuple(grads)


def grid4d_encode(xyzt: torch.Tensor, tables: Sequence[torch.Tensor],
                  resolutions: Sequence[torch.Tensor], cfgs,
                  spatial_mask: Optional[torch.Tensor] = None,
                  temporal_mask: Optional[torch.Tensor] = None, *,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """A Grid4D encoder's ``combined``: its tables' encodings of xyzt, times
    their masks, concatenated and cast to ``out_dtype``, differentiable in
    the tables.

    Args:
        xyzt: (B, 4) coordinates in [0, 1]; no gradient flows to them, as in
            the JAX train step.
        tables: the (L, T, F) fp32 tables in :data:`TABLES` order: spatial
            and temporal, then xyt, yzt and xzt when the config has them.
        resolutions: each table's (L,) fp32 resolutions.
        cfgs: each table's ``HashEncodingConfig``.
        spatial_mask, temporal_mask: (B,) bool or None; False zeroes the
            features of the tables the mask applies to.
        out_dtype: the compute dtype.

    Returns:
        (B, sum of L * F) in ``out_dtype``.
    """
    if len(tables) not in (2, len(TABLES)):
        raise ValueError(f"grid4d_encode takes 2 or {len(TABLES)} tables, "
                         f"got {len(tables)}")
    dims = [(t.shape[-1], len(cols)) for t, (_, cols, _) in zip(tables,
                                                               TABLES)]
    if not kernels.grid4d_encode_route(dims, out_dtype):
        return _compose(hash_encoding.hash_encode, xyzt, tables, resolutions,
                        cfgs, spatial_mask, temporal_mask, out_dtype)
    if torch.is_grad_enabled() and xyzt.requires_grad:
        raise NotImplementedError(
            "grid4d_encode has no gradient with respect to xyzt; only the "
            "tables are differentiated, as in the JAX train step")
    return _Grid4DEncode.apply(xyzt.to(torch.float32), spatial_mask,
                               temporal_mask, tuple(resolutions), tuple(cfgs),
                               out_dtype, *tables)
