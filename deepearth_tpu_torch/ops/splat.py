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
  per pixel and list segment the transmittance after the segment and the
  colour seen behind it for the backward) for CUDA tensors,
  :func:`composite_plain` and :func:`composite_bwd_plain` for CPU tensors.
  It composites one ordered list per region of the image: a 16 x 16 tile
  with its list from :func:`bin_tiles`, or the whole image with every
  Gaussian (the dense render).
* :func:`composite_segments_plain` and :func:`composite_segments_bwd_plain`:
  K9's algorithm written out in plain PyTorch (the list cut into
  segments, the transmittance as mantissa and exponent, the segments
  combined; the backward from the kept state, each segment walked back to
  front), which the tests hold against JAX and the kernels against.

An entry of the lists is a mean ``xy`` in pixels, the coefficients
``abc`` of its quadratic form ``a dx^2 + b dx dy + c dy^2`` (the caller
forms them from the inverse 2-D covariance, so that autograd sends their
gradients to the entries JAX sends them to), an opacity (0 for an unfilled
slot or a Gaussian behind the camera) and a colour.
"""

from __future__ import annotations

from typing import Optional

import math

import torch

from .. import kernels

CLIP = 0.995  # the largest alpha, as in JAX
# alpha's exp as K9 takes it: 2^(q') with q' = q * EXP2_SCALE (fp32)
EXP2_SCALE = -0.5 * math.log2(math.e)
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


def _region_pixels(lists: int, width: int, region_h: int, region_w: int,
                   device) -> torch.Tensor:
    """(L, region pixels, 2) fp32 pixel centres of each list's region,
    row-major, x first."""
    r = torch.arange(lists, device=device)
    p = torch.arange(region_h * region_w, device=device)
    regions_x = width // region_w
    origin = torch.stack([(r % regions_x * region_w).float(),
                          (r // regions_x * region_h).float()], dim=-1)
    local = torch.stack([(p % region_w).float() + 0.5,
                         (p // region_w).float() + 0.5], dim=-1)
    return origin[:, None] + local[None]


def _to_image(per_pixel: torch.Tensor, height: int, width: int,
              region_h: int, region_w: int) -> torch.Tensor:
    """(L, region pixels, ...) rearranged to (height, width, ...)."""
    rest = per_pixel.shape[2:]
    return (per_pixel.reshape(height // region_h, width // region_w,
                              region_h, region_w, *rest)
            .transpose(1, 2).reshape(height, width, *rest))


def _from_image(image: torch.Tensor, region_h: int, region_w: int):
    """(height, width, ...) rearranged to (L, region pixels, ...)."""
    height, width = image.shape[:2]
    rest = image.shape[2:]
    return (image.reshape(height // region_h, region_h, width // region_w,
                          region_w, *rest)
            .transpose(1, 2).reshape(-1, region_h * region_w, *rest))


def composite_plain(xy: torch.Tensor, abc: torch.Tensor, opac: torch.Tensor,
                    color: torch.Tensor, background: Optional[torch.Tensor],
                    height: int, width: int, region_h: int, region_w: int,
                    region_chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version of K9's forward (any device, differentiable):
    JAX's arithmetic (``exp``, ``clip`` as ``maximum`` then ``minimum``,
    ``cumprod``, an ``einsum`` of the weights and colours) over
    ``region_chunk`` regions at a time, their pixels cut so that one
    (regions, pixels, entries) intermediate holds at most
    :data:`PLAIN_CHUNK_ELEMENTS`. Arguments as :func:`composite`.

    The weighted colours are summed in float64 and rounded once: a running
    fp32 sum over a long list rounds away every term below half an ulp of
    the sum, which leaves the image low by a few ulps on average (the
    float64 reference in ``chip_smoke.py`` phase 23 reads the bias)."""
    lists, k = xy.shape[:2]
    pixels = _region_pixels(lists, width, region_h, region_w, xy.device)
    zero, clip = xy.new_zeros(()), xy.new_tensor(CLIP)
    pieces = []
    for r0 in range(0, lists, region_chunk):
        sl = slice(r0, min(lists, r0 + region_chunk))
        a, b, c = (abc[sl, None, :, i] for i in range(3))
        step = max(1, PLAIN_CHUNK_ELEMENTS // (len(pixels[sl]) * max(k, 1)))
        rows = []
        for p0 in range(0, pixels.shape[1], step):
            px = pixels[sl, p0:p0 + step]
            dx = px[:, :, None, 0] - xy[sl, None, :, 0]
            dy = px[:, :, None, 1] - xy[sl, None, :, 1]
            q = a * dx * dx + b * dx * dy + c * dy * dy
            alpha = torch.minimum(torch.maximum(
                opac[sl, None, :] * torch.exp(-0.5 * q), zero), clip)
            trans = torch.cumprod(1.0 - alpha, dim=-1)
            t_before = torch.cat([torch.ones_like(alpha[..., :1]),
                                  trans[..., :-1]], dim=-1)
            img = torch.einsum("cpk,ckd->cpd", (alpha * t_before).double(),
                               color[sl].double()).to(alpha.dtype)
            if background is not None:
                img = img + trans[..., -1:] * background
            rows.append(img)
        pieces.append(torch.cat(rows, dim=1))
    return _to_image(torch.cat(pieces), height, width, region_h, region_w)


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


def _segmented(t: torch.Tensor, segments: int, seg_len: int):
    """(L, K, ...) as (L, segments, seg_len, ...), zeros past K."""
    pad = segments * seg_len - t.shape[1]
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
    return t.reshape(t.shape[0], segments, seg_len, *t.shape[2:])


def _segment_alpha(xy, abc, opac, px):
    """K9's alpha for entries (L, S, n, ...) at pixels (L, P, 2): e =
    exp(-q / 2) as 2^(q * EXP2_SCALE), raw = opac e, alpha = clip(raw),
    and dx, dy; each (L, P, S, n)."""
    dx = px[:, :, None, None, 0] - xy[:, None, ..., 0]
    dy = px[:, :, None, None, 1] - xy[:, None, ..., 1]
    a, b, c = (abc[:, None, ..., i] * EXP2_SCALE for i in range(3))
    e = torch.exp2((a * dx + b * dy) * dx + c * dy * dy)
    raw = opac[:, None] * e
    return e, raw, torch.clamp(raw, 0.0, CLIP), dx, dy


def composite_segments_plain(xy, abc, opac, color, background, height,
                             width, region_h, region_w, segments=None):
    """K9-fwd's algorithm in plain PyTorch (any device): each list cut into
    ``segments`` runs of ceil(K / segments) entries (by default
    ``kernels.splat_plan``'s), each run composited front to back from
    T = 1 with T as mantissa m and binary exponent (m brought back above
    2^-64 every 8 entries), then the runs combined: the colour behind run
    s is B_s = C_{s+1} + T_{s+1} B_{s+1} (B_{S-1} the background or 0),
    the pixel C_0 + T_0 B_0. Arguments as :func:`composite`. Returns the
    (height, width, 3) image and the state K9 keeps, (L, S, 5, region
    pixels): the transmittance after each run (mantissa in [0.5, 1),
    exponent) and the colour behind it."""
    lists, k = xy.shape[:2]
    if segments is None:
        segments = kernels.splat_plan(k, region_h, region_w)[0]
    seg_len = max(1, -(-k // segments))
    xs, abcs, ops, cols = (_segmented(t, segments, seg_len)
                           for t in (xy, abc, opac, color))
    px = _region_pixels(lists, width, region_h, region_w, xy.device)
    _, _, alpha, _, _ = _segment_alpha(xs, abcs, ops, px)
    m = torch.ones(alpha.shape[:3], device=xy.device)
    scale = torch.ones_like(m)
    ex = torch.zeros(m.shape, dtype=torch.int32, device=xy.device)
    col = m.new_zeros(m.shape + (3,))
    for j in range(seg_len):
        a = alpha[..., j]
        col = col + (a * (m * scale))[..., None] * cols[:, None, :, j]
        m = m * (1.0 - a)
        if j % 8 == 7 or j == seg_len - 1:
            low = m < 2.0 ** -64
            m = torch.where(low, m * 2.0 ** 64, m)
            scale = torch.where(low, scale * 2.0 ** -64, scale)
            ex = ex - 64 * low.int()
    behind = (xy.new_zeros(3) if background is None else background)
    behind = behind.expand(lists, px.shape[1], 3)
    behinds, ends = [None] * segments, []
    for s in reversed(range(segments)):
        behinds[s] = behind
        behind = col[:, :, s] + torch.ldexp(m[:, :, s], ex[:, :, s])[
            ..., None] * behind
    mant = torch.ones_like(m[:, :, 0])
    expo = torch.zeros_like(ex[:, :, 0])
    for s in range(segments):
        mant, e2 = torch.frexp(mant * m[:, :, s])
        expo = expo + ex[:, :, s] + e2
        ends.append(torch.cat([mant[..., None], expo[..., None].float(),
                               behinds[s]], -1))
    state = torch.stack(ends, 1).transpose(2, 3).contiguous()
    return _to_image(behind, height, width, region_h, region_w), state


def composite_segments_bwd_plain(xy, abc, opac, color, background, state,
                                 dout, height, width, region_h, region_w):
    """K9-bwd's algorithm in plain PyTorch (any device), from the state
    :func:`composite_segments_plain` keeps: each run walked back to front
    from the transmittance after it, dividing (1 - alpha_j) back out (m
    brought back under 2^32 every 4 entries), and carrying Q, the colour
    behind the entry dotted with dout: Q_{j-1} = alpha_j (c_j . dout) +
    (1 - alpha_j) Q_j, from the colour behind the run. d alpha_j = T_j
    (c_j . dout - Q_j) and jnp.clip's gradient (1 inside, 1/2 on a bound).
    Returns the gradients of xy, abc, opac, color and background (None
    without one)."""
    lists, k = xy.shape[:2]
    segments = state.shape[1]
    seg_len = max(1, -(-k // segments))
    xs, abcs, ops, cols = (_segmented(t, segments, seg_len)
                           for t in (xy, abc, opac, color))
    px = _region_pixels(lists, width, region_h, region_w, xy.device)
    e, raw, alpha, dx, dy = _segment_alpha(xs, abcs, ops, px)
    g = _from_image(dout, region_h, region_w)  # (L, P, 3)
    st = state.permute(0, 3, 1, 2)  # (L, P, S, 5)
    m, ex = st[..., 0], st[..., 1].int()
    q = (st[..., 2:] * g[:, :, None]).sum(-1)
    scale = torch.ldexp(torch.ones_like(m), ex)
    dbg = None
    if background is not None:
        dbg = ((m * scale)[:, :, -1, None] * g).sum((0, 1))
    a_, b_, c_ = (abcs[:, None, ..., i] for i in range(3))
    grads = [[None] * seg_len for _ in range(5)]  # dxy dabc dop dcol
    for j in reversed(range(seg_len)):
        a = alpha[..., j]
        keep = 1.0 - a
        m = m / keep
        t = m * scale
        cdot = (cols[:, None, :, j] * g[:, :, None]).sum(-1)
        dalpha = t * (cdot - q)
        q = a * cdot + keep * q
        r = raw[..., j]
        one = torch.ones_like(r)
        pass_ = torch.where((r > 0) & (r < CLIP), one,
                            torch.where((r == 0) | (r == CLIP), 0.5 * one,
                                        0.0 * one))
        draw = dalpha * pass_
        d = draw * r  # d q = -d / 2
        ddx, ddy = d * dx[..., j], d * dy[..., j]
        aj, bj, cj = a_[..., j], b_[..., j], c_[..., j]
        grads[0][j] = torch.stack(
            [(0.5 * (2.0 * aj * ddx + bj * ddy)).sum(1),
             (0.5 * (bj * ddx + 2.0 * cj * ddy)).sum(1)], -1)
        grads[1][j] = torch.stack(
            [(-0.5 * ddx * dx[..., j]).sum(1), (-0.5 * ddx * dy[..., j]).sum(1),
             (-0.5 * ddy * dy[..., j]).sum(1)], -1)
        grads[2][j] = (draw * e[..., j]).sum(1)
        grads[3][j] = ((a * t)[..., None] * g[:, :, None]).sum(1)
        if j % 4 == 0:
            big = m > 2.0 ** 32
            m = torch.where(big, m * 2.0 ** -64, m)
            ex = ex + 64 * big.int()
            scale = torch.ldexp(torch.ones_like(m), ex)
    out = []
    for per_j in grads[:4]:
        t = torch.stack(per_j, 2)  # (L, S, n, ...)
        out.append(t.reshape(lists, segments * seg_len,
                             *t.shape[3:])[:, :k])
    return (*out, dbg)


def final_transmittance(state: torch.Tensor, height: int, width: int,
                        region_h: int, region_w: int) -> torch.Tensor:
    """Each pixel's transmittance after its whole list, (height, width),
    from K9's kept state (the mantissa and exponent after the last run)."""
    last = state[:, -1]
    return _to_image(torch.ldexp(last[:, 0], last[:, 1].int())[..., None],
                     height, width, region_h, region_w)[..., 0]


class _Composite(torch.autograd.Function):
    """(K9-fwd, K9-bwd) for CUDA tensors, their plain versions for CPU
    tensors. With ``keep_state`` (a backward will follow) K9-fwd also keeps
    its per-segment state, which K9-bwd reads."""

    @staticmethod
    def forward(ctx, xy, abc, opac, color, background, height, width,
                region_h, region_w, keep_state):
        ctx.geometry = (height, width, region_h, region_w)
        if xy.device.type == "cpu":
            ctx.save_for_backward(xy, abc, opac, color, background)
            return composite_plain(xy, abc, opac, color, background, height,
                                   width, region_h, region_w)
        out = kernels.splat_composite_fwd(xy, abc, opac, color, background,
                                          height, width, region_h, region_w,
                                          keep_state)
        if not keep_state:
            return out
        out, state = out
        ctx.save_for_backward(xy, abc, opac, color, background, state)
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
    keep_state = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)
    return _Composite.apply(*inputs, height, width, region_h, region_w,
                            keep_state)
