"""Gaussian splatting's tile binning and compositing, PyTorch port.

Counterpart of the XLA programs inside ``deepearth_tpu/reconstruction/
gaussian_splat.py``: ``render_tiled``'s intersect test and ``lax.top_k``
(:253-259), and the front-to-back "over" compositing of ``render_tiled``
(:261-283) and of the dense ``render`` (:143-157). On the TPU they are XLA
over dense (pixels, K) arrays; here they are hand-written kernels:

* :func:`bin_tiles`: K8 (``kernels.splat_bin``) for a CUDA tensor, for a
  CPU tensor :func:`bin_tiles_plain`. Its indices carry no gradient, as
  ``argsort`` and ``top_k`` carry none in JAX.
* :func:`composite`: a ``torch.autograd.Function`` over K9's forward and
  backward (``kernels.splat_composite_fwd`` / ``_bwd``, the forward keeping
  each pixel's final transmittance for the backward) for CUDA tensors,
  :func:`composite_plain` and :func:`composite_bwd_plain` for CPU tensors.
  It composites one ordered list per region of the image: a 16 x 16 tile
  with its list from :func:`bin_tiles`, or the whole image with every
  Gaussian (the dense render).

An entry of the lists is a mean ``xy`` in pixels, the coefficients
``abc`` of its quadratic form ``a dx^2 + b dx dy + c dy^2`` (the caller
forms them from the inverse 2-D covariance, so that autograd sends their
gradients to the entries JAX sends them to), an opacity (0 for an unfilled
slot or a Gaussian behind the camera) and a colour.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

CLIP = 0.995  # the largest alpha, as in JAX
# elements of one (regions, pixels, entries) intermediate of the plain
# compositing: 64 MB in fp32
PLAIN_CHUNK_ELEMENTS = 1 << 24


def bin_tiles_plain(xy: torch.Tensor, radius: torch.Tensor,
                    valid: torch.Tensor, tiles_x: int, tiles_y: int,
                    tile_size: int, k: int, tile_chunk: int = 32):
    """Plain PyTorch version of K8 (any device): JAX's intersect test and
    ``top_k`` over ``where(hit, -rank, -(G + 1))``, chunked over tiles as
    ``lax.map`` chunks them. Returns (idx (T, k) int32 with unfilled slots
    0, count (T,) int32)."""
    g = xy.shape[0]
    tile = torch.arange(tiles_x * tiles_y, device=xy.device)
    # the tiles' centres as JAX forms them, tile * ts + ts / 2.0, in fp32
    centers = torch.stack([(tile % tiles_x * tile_size).float(),
                           (tile // tiles_x * tile_size).float()],
                          dim=-1) + tile_size / 2.0
    half = tile_size / 2.0
    rank = torch.arange(g, device=xy.device)
    idx, count = [], []
    for ctr in centers.split(tile_chunk):
        dxy = (xy[None] - ctr[:, None, :]).abs()
        hit = valid[None] & (dxy <= half + radius[None, :, None]).all(-1)
        key = torch.where(hit, -rank[None], torch.full_like(rank, -(g + 1)))
        kv, kidx = torch.topk(key, k, dim=-1)
        ok = kv > -(g + 1)
        idx.append(torch.where(ok, kidx, 0).to(torch.int32))
        count.append(ok.sum(-1).to(torch.int32))
    return torch.cat(idx), torch.cat(count)


def bin_tiles(xy: torch.Tensor, radius: torch.Tensor, valid: torch.Tensor,
              tiles_x: int, tiles_y: int, tile_size: int, k: int,
              tile_chunk: int = 32):
    """Each tile's first ``k`` depth-sorted Gaussians that are ``valid``
    and whose box of half width ``tile_size / 2 + radius`` holds the tile's
    centre: (idx (T, k) int32, unfilled slots 0; count (T,) int32). xy
    (G, 2), radius (G,) fp32, valid (G,) bool, sorted front to back. K8 for
    a CUDA tensor, :func:`bin_tiles_plain` for a CPU one."""
    with torch.no_grad():
        if xy.device.type == "cpu":
            return bin_tiles_plain(xy, radius, valid, tiles_x, tiles_y,
                                   tile_size, k, tile_chunk)
        return kernels.splat_bin(xy, radius, valid, tiles_x, tiles_y,
                                 tile_size, k)


def _local_pixels(region_h: int, region_w: int, device) -> torch.Tensor:
    """(region_h * region_w, 2) fp32 pixel centres of a region, row-major,
    x first."""
    p = torch.arange(region_h * region_w, device=device)
    return torch.stack([(p % region_w).float() + 0.5,
                        (p // region_w).float() + 0.5], dim=-1)


def composite_plain(xy: torch.Tensor, abc: torch.Tensor, opac: torch.Tensor,
                    color: torch.Tensor, background: Optional[torch.Tensor],
                    height: int, width: int, region_h: int, region_w: int,
                    region_chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version of K9's forward (any device, differentiable):
    JAX's arithmetic (``exp``, ``clip`` as ``maximum`` then ``minimum``,
    ``cumprod``, an ``einsum`` of the weights and colours) over
    ``region_chunk`` regions at a time, their pixels cut so that one
    (regions, pixels, entries) intermediate holds at most
    :data:`PLAIN_CHUNK_ELEMENTS`. Arguments as :func:`composite`."""
    lists, k = xy.shape[:2]
    regions_x = width // region_w
    local = _local_pixels(region_h, region_w, xy.device)
    zero, clip = xy.new_zeros(()), xy.new_tensor(CLIP)
    pieces = []
    for r0 in range(0, lists, region_chunk):
        r = torch.arange(r0, min(lists, r0 + region_chunk), device=xy.device)
        origin = torch.stack([(r % regions_x * region_w).float(),
                              (r // regions_x * region_h).float()], dim=-1)
        sl = slice(r0, r0 + len(r))
        a, b, c = (abc[sl, None, :, i] for i in range(3))
        step = max(1, PLAIN_CHUNK_ELEMENTS // (len(r) * max(k, 1)))
        rows = []
        for p0 in range(0, len(local), step):
            px = origin[:, None, :] + local[None, p0:p0 + step]
            dx = px[:, :, None, 0] - xy[sl, None, :, 0]
            dy = px[:, :, None, 1] - xy[sl, None, :, 1]
            q = a * dx * dx + b * dx * dy + c * dy * dy
            alpha = torch.minimum(torch.maximum(
                opac[sl, None, :] * torch.exp(-0.5 * q), zero), clip)
            trans = torch.cumprod(1.0 - alpha, dim=-1)
            t_before = torch.cat([torch.ones_like(alpha[..., :1]),
                                  trans[..., :-1]], dim=-1)
            img = torch.einsum("cpk,ckd->cpd", alpha * t_before, color[sl])
            if background is not None:
                img = img + trans[..., -1:] * background
            rows.append(img)
        pieces.append(torch.cat(rows, dim=1))
    regions_y = height // region_h
    return (torch.cat(pieces).reshape(regions_y, regions_x, region_h,
                                      region_w, 3)
            .permute(0, 2, 1, 3, 4).reshape(height, width, 3))


def composite_bwd_plain(xy, abc, opac, color, background, dout, height,
                        width, region_h, region_w):
    """Plain PyTorch version of K9's backward: autograd through
    :func:`composite_plain` recomputed. Returns the gradients of xy, abc,
    opac, color and background (None without one)."""
    inputs = [t.detach().requires_grad_(True) for t in (xy, abc, opac, color)]
    bg = None if background is None else background.detach().requires_grad_()
    with torch.enable_grad():
        out = composite_plain(*inputs, bg, height, width, region_h, region_w)
        grads = torch.autograd.grad(out, inputs + ([] if bg is None else [bg]),
                                    dout)
    return (*grads[:4], grads[4] if bg is not None else None)


class _Composite(torch.autograd.Function):
    """(K9-fwd, K9-bwd) for CUDA tensors, their plain versions for CPU
    tensors. With ``keep_final`` (a backward will follow) K9-fwd also keeps
    each pixel's final transmittance, which K9-bwd reads."""

    @staticmethod
    def forward(ctx, xy, abc, opac, color, background, height, width,
                region_h, region_w, keep_final):
        ctx.geometry = (height, width, region_h, region_w)
        if xy.device.type == "cpu":
            ctx.save_for_backward(xy, abc, opac, color, background)
            return composite_plain(xy, abc, opac, color, background, height,
                                   width, region_h, region_w)
        out = kernels.splat_composite_fwd(xy, abc, opac, color, background,
                                          height, width, region_h, region_w,
                                          keep_final)
        if not keep_final:
            return out
        out, t_final = out
        ctx.save_for_backward(xy, abc, opac, color, background, t_final)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        if saved[0].device.type == "cpu":
            grads = composite_bwd_plain(*saved, dout.contiguous(),
                                        *ctx.geometry)
        else:
            grads = kernels.splat_composite_bwd(*saved, dout.contiguous(),
                                                *ctx.geometry)
        return (*grads, None, None, None, None, None)


def composite(xy: torch.Tensor, abc: torch.Tensor, opac: torch.Tensor,
              color: torch.Tensor, background: Optional[torch.Tensor],
              height: int, width: int, region_h: int,
              region_w: int) -> torch.Tensor:
    """Front-to-back "over" compositing, differentiable in every input.

    Args:
        xy: (L, K, 2) entry means in pixels; list l is composited over
            region l (row-major) of the height x width image, cut into
            region_h x region_w regions.
        abc: (L, K, 3) quadratic-form coefficients (a, b, c).
        opac: (L, K) opacities, 0 for an entry that contributes nothing.
        color: (L, K, 3) colours.
        background: (3,) or None.

    Per pixel, alpha_j = clip(opac_j exp(-(a dx^2 + b dx dy + c dy^2) / 2),
    0, 0.995) over every entry in order, and the pixel is
    sum_j alpha_j T_j color_j + T_K background, T_j = prod_{i<j}
    (1 - alpha_i). Returns (height, width, 3) fp32.
    """
    inputs = (xy, abc, opac, color, background)
    keep_final = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)
    return _Composite.apply(*inputs, height, width, region_h, region_w,
                            keep_final)
