"""Differentiable 3D Gaussian splatting, PyTorch port.

Counterpart of ``deepearth_tpu/reconstruction/gaussian_splat.py``. The
projection, the depth sort and the per-Gaussian quantities are plain
torch; the tile binning and the compositing are the hand-written kernels of
:mod:`deepearth_tpu_torch.ops.splat` on the card (K8, K9-fwd, K9-bwd) and
their plain versions on the CPU. :func:`render` composites every Gaussian at
every pixel (one list for the whole image); :func:`render_tiled` gives each
16 x 16 tile the first ``max_per_tile`` Gaussians that reach it, in depth
order. Scenes train with ``training.optimizers.Adam`` (``optax.adam``'s
arithmetic), and
:func:`fit_scene_adaptive` densifies and prunes between steps, carrying
both moments across each resize.

Conventions: row-vector camera, OpenCV pinhole intrinsics, quaternions
wxyz. A scene lives on the device of its tensors; :func:`init_scene`,
:func:`fit_scene` and :func:`fit_scene_adaptive` draw from a
``torch.Generator`` (JAX's keys give other numbers: tests convert scenes
with ``convert.gaussian_scene_from_jax``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import splat
from ..training.optimizers import Adam, AdamState


class GaussianScene(NamedTuple):
    """Trainable scene parameters."""

    means: torch.Tensor  # (G, 3) world positions
    log_scales: torch.Tensor  # (G, 3)
    quats: torch.Tensor  # (G, 4) wxyz, normalized at use
    colors: torch.Tensor  # (G, 3) pre-sigmoid rgb
    opacity_logits: torch.Tensor  # (G,)


class Camera(NamedTuple):
    rotation: torch.Tensor  # (3, 3) world->camera
    translation: torch.Tensor  # (3,) world->camera: x_cam = R @ x + t
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def init_scene(generator: torch.Generator, n_gaussians: int,
               extent: float = 1.0) -> GaussianScene:
    """A random scene on the generator's device: means uniform in
    [-extent, extent)^3, scales 0.1 * extent, identity rotations, colours
    0.1 * N(0, 1), opacity sigmoid(-1)."""
    device = generator.device
    means = (torch.rand((n_gaussians, 3), generator=generator, device=device)
             * (2 * extent) - extent)
    colors = torch.randn((n_gaussians, 3), generator=generator,
                         device=device) * 0.1
    log_scale = torch.log(torch.tensor(0.1 * extent, device=device))
    return GaussianScene(
        means=means,
        log_scales=log_scale.expand(n_gaussians, 3).clone(),
        quats=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(
            n_gaussians, 1),
        colors=colors,
        opacity_logits=torch.full((n_gaussians,), -1.0, device=device),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def covariance_3d(scene: GaussianScene) -> torch.Tensor:
    """(G, 3, 3) Sigma = R S S^T R^T."""
    R = quat_to_rotmat(scene.quats)
    RS = R * torch.exp(scene.log_scales)[:, None, :]
    return RS @ RS.transpose(-1, -2)


def project_gaussians(scene: GaussianScene, cam: Camera, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to image space: xy (G, 2) pixel means, cov2d (G, 2, 2)
    image-space covariances (+0.3 px blur, gsplat's default), depth (G,)
    camera-space z."""
    p_cam = scene.means @ cam.rotation.T + cam.translation
    z = torch.clamp_min(p_cam[:, 2], eps)
    x, y = p_cam[:, 0], p_cam[:, 1]
    xy = torch.stack([cam.fx * x / z + cam.cx, cam.fy * y / z + cam.cy], -1)
    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([cam.fx / z, zero, -cam.fx * x / (z * z)], -1),
        torch.stack([zero, cam.fy / z, -cam.fy * y / (z * z)], -1),
    ], dim=-2)
    W = cam.rotation
    cov_cam = W @ covariance_3d(scene) @ W.T
    cov2d = J @ cov_cam @ J.transpose(-1, -2)
    cov2d = cov2d + 0.3 * torch.eye(2, device=cov2d.device)
    return xy, cov2d, p_cam[:, 2]


def _inverse_cov2d(cov2d: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form 2x2 inverse. Returns (inv, det)."""
    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    det = torch.clamp_min(det, 1e-9)
    inv = torch.stack([
        torch.stack([cov2d[:, 1, 1], -cov2d[:, 0, 1]], -1),
        torch.stack([-cov2d[:, 1, 0], cov2d[:, 0, 0]], -1),
    ], dim=-2) / det[:, None, None]
    return inv, det


def _sorted(scene: GaussianScene, cam: Camera):
    """Projected Gaussians sorted front to back (stable, as jnp.argsort):
    xy, cov2d, depth, colours and opacities after the sigmoid. The cov2d of
    a Gaussian behind the camera (depth <= 1e-4, which no render shows) is
    the identity: its own reaches ~1e24, its determinant overflows, and the
    NaN of its inverse would reach its gradients through the zeros that
    exclude it."""
    xy, cov2d, depth = project_gaussians(scene, cam)
    order = torch.argsort(depth, stable=True)
    depth = depth[order]
    cov2d = torch.where((depth > 1e-4)[:, None, None], cov2d[order],
                        torch.eye(2, device=cov2d.device))
    return (xy[order], cov2d, depth, torch.sigmoid(scene.colors[order]),
            torch.sigmoid(scene.opacity_logits[order]))


class SplatLists(NamedTuple):
    """What a render hands K9 (``lists``: xy, abc, opac, color, each (L, K,
    ...); ``geometry``: height, width, region height, region width) and,
    tiled, what it handed K8 (``binning``) and K8's ``idx`` / ``count``."""

    lists: Tuple[torch.Tensor, ...]
    geometry: Tuple[int, int, int, int]
    binning: Optional[tuple] = None
    idx: Optional[torch.Tensor] = None
    count: Optional[torch.Tensor] = None


def _kept(keep: torch.Tensor, xy, abc, opac):
    """xy, abc and opac with the entries off ``keep`` zeroed: zero opacity
    and a zero quadratic form, so that the entry adds nothing to the image
    and no gradient flows back through it."""
    return (torch.where(keep[..., None], xy, torch.zeros_like(xy)),
            torch.where(keep[..., None], abc, torch.zeros_like(abc)),
            torch.where(keep, opac, torch.zeros_like(opac)))


def dense_lists(scene: GaussianScene, cam: Camera) -> SplatLists:
    """:func:`render`'s one list: every Gaussian front to back, for the
    whole image. Gaussians behind the camera (depth <= 1e-4) enter as
    zeros (JAX's ``where`` at the alpha)."""
    xy, cov2d, depth, colors, opac = _sorted(scene, cam)
    inv, _ = _inverse_cov2d(cov2d)
    # JAX's einsum d^T inv d: both off-diagonal entries times dx dy
    abc = torch.stack([inv[:, 0, 0], inv[:, 0, 1] + inv[:, 1, 0],
                       inv[:, 1, 1]], dim=-1)
    xy, abc, opac = _kept(depth > 1e-4, xy, abc, opac)
    H, W = cam.height, cam.width
    return SplatLists((xy[None], abc[None], opac[None], colors[None]),
                      (H, W, H, W))


def tile_lists(scene: GaussianScene, cam: Camera, *, tile_size: int = 16,
               max_per_tile: int = 512, radius_sigma: float = 3.5,
               tile_chunk: int = 32) -> SplatLists:
    """:func:`render_tiled`'s lists: K8 (``ops.splat.bin_tiles``) picks
    each tile's first ``K = min(max_per_tile, G)`` depth-sorted Gaussians
    in front of the camera whose ``radius_sigma``-sigma box meets it; the
    entries are gathered (unfilled slots as zeros)."""
    H, W = cam.height, cam.width
    ts = tile_size
    if H % ts or W % ts:
        raise ValueError(f"image {H}x{W} not divisible by tile_size={ts}")
    xy, cov2d, depth, colors, opac = _sorted(scene, cam)
    inv, _ = _inverse_cov2d(cov2d)
    # conservative screen-space radius from the largest eigenvalue of cov2d
    a, b, c = cov2d[:, 0, 0], cov2d[:, 0, 1], cov2d[:, 1, 1]
    lam_max = 0.5 * (a + c) + torch.sqrt(
        torch.clamp_min(0.25 * (a - c) ** 2 + b * b, 0.0))
    radius = radius_sigma * torch.sqrt(torch.clamp_min(lam_max, 0.0))
    binning = (xy.detach(), radius.detach(), depth > 1e-4, W // ts, H // ts,
               ts, min(max_per_tile, xy.shape[0]))
    idx, count = splat.bin_tiles(*binning, tile_chunk)
    rows = idx.long()
    ok = torch.arange(rows.shape[1], device=rows.device)[None] < count[:, None]
    # JAX's tiled quadratic form reads inv[0, 1] only: 2 inv01 dx dy
    abc = torch.stack([inv[:, 0, 0], 2.0 * inv[:, 0, 1], inv[:, 1, 1]],
                      dim=-1)
    xyk, abck, opk = _kept(ok, xy[rows], abc[rows], opac[rows])
    return SplatLists((xyk, abck, opk, colors[rows]), (H, W, ts, ts),
                      binning, idx, count)


def render(scene: GaussianScene, cam: Camera,
           background: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render (H, W, 3) with depth-sorted alpha compositing of every
    Gaussian at every pixel: K9 over one list (all G, front to back) shared
    by the whole image (:func:`dense_lists`). Gaussians behind the camera
    neither show nor receive a gradient."""
    lists = dense_lists(scene, cam)
    return splat.composite(*lists.lists, background, *lists.geometry)


def render_tiled(scene: GaussianScene, cam: Camera,
                 background: Optional[torch.Tensor] = None, *,
                 tile_size: int = 16, max_per_tile: int = 512,
                 radius_sigma: float = 3.5,
                 tile_chunk: int = 32) -> torch.Tensor:
    """Tile rasterizer: one global depth sort; per tile, K8 picks the first
    ``K = min(max_per_tile, G)`` Gaussians in front of the camera whose
    ``radius_sigma``-sigma box meets the tile (:func:`tile_lists`); K9
    composites each tile's list over its pixels. Gradients flow through
    the per-tile gathers; the selection carries none. ``tile_chunk`` tiles
    at a time in the plain versions, as JAX's ``lax.map``. Results differ
    from :func:`render` by at most the tail beyond ``radius_sigma``."""
    lists = tile_lists(scene, cam, tile_size=tile_size,
                       max_per_tile=max_per_tile, radius_sigma=radius_sigma,
                       tile_chunk=tile_chunk)
    return splat.composite(*lists.lists, background, *lists.geometry)


def prune_scene(scene: GaussianScene,
                min_opacity: float = 0.01) -> GaussianScene:
    """Soft prune: the opacity logit of a Gaussian under ``min_opacity``
    becomes -1e4 (rows stay; :func:`densify_and_prune` resizes)."""
    keep = torch.sigmoid(scene.opacity_logits) >= min_opacity
    return scene._replace(opacity_logits=torch.where(
        keep, scene.opacity_logits,
        torch.full_like(scene.opacity_logits, -1e4)))


def _step_fn(cam: Camera, tx: Adam, renderer: str, stats: bool):
    render_fn = render if renderer == "dense" else render_tiled

    def step(scene: GaussianScene, opt_state: AdamState,
             target: torch.Tensor):
        leaves = [t.detach().requires_grad_(True) for t in scene]
        with torch.enable_grad():
            img = render_fn(GaussianScene(*leaves), cam)
            loss = torch.mean((img - target) ** 2)
            grads = GaussianScene(*torch.autograd.grad(loss, leaves))
        updates, opt_state = tx.update(grads, opt_state)
        scene = GaussianScene(*(p.detach() + u for p, u in zip(scene,
                                                                updates)))
        if stats:
            gnorm = torch.linalg.vector_norm(grads.means, dim=-1)
            return scene, opt_state, loss.detach(), gnorm
        return scene, opt_state, loss.detach()

    return step


def make_train_step(cam: Camera, lr: float = 1e-2, renderer: str = "dense"
                    ) -> Tuple[Callable, Callable]:
    """Photometric training step: MSE to a target image. Returns
    ``(init, step)``: ``init(scene)`` the optimizer state, ``step(scene,
    opt_state, target)`` -> (scene, opt_state, loss). ``renderer='tiled'``
    swaps in :func:`render_tiled`."""
    tx = Adam(lr)
    return tx.init, _step_fn(cam, tx, renderer, stats=False)


def make_train_step_with_stats(cam: Camera, lr: float = 1e-2,
                               renderer: str = "dense"
                               ) -> Tuple[Adam, Callable]:
    """Like :func:`make_train_step`, returning ``(tx, step)``; ``step``
    also returns the per-Gaussian norms of the means' gradient (which
    drive densification)."""
    tx = Adam(lr)
    return tx, _step_fn(cam, tx, renderer, stats=True)


def fit_scene(target: torch.Tensor, cam: Camera, n_gaussians: int = 256,
              steps: int = 300, lr: float = 2e-2, seed: int = 0,
              extent: float = 1.0, renderer: str = "dense"
              ) -> Tuple[GaussianScene, float]:
    """Fit a scene to one target image on the target's device; returns
    (scene, final loss)."""
    gen = torch.Generator(device=target.device).manual_seed(seed)
    scene = init_scene(gen, n_gaussians, extent)
    init, step = make_train_step(cam, lr, renderer=renderer)
    opt_state = init(scene)
    loss = torch.tensor(math.inf)
    for _ in range(steps):
        scene, opt_state, loss = step(scene, opt_state, target)
    return scene, float(loss)


def densify_and_prune(scene: GaussianScene, grad_avg: torch.Tensor,
                      generator: torch.Generator, *,
                      grad_threshold: float = 5e-4, split_scale: float = 0.05,
                      split_factor: float = 1.6, min_opacity: float = 0.01,
                      max_gaussians: int = 50_000):
    """Host-side adaptive density control.

    * prune: drop Gaussians with opacity < ``min_opacity``
    * clone: duplicate small high-gradient Gaussians in place
    * split: replace large high-gradient Gaussians with two children
      sampled from the parent (noise from ``generator``, on the scene's
      device), scales divided by ``split_factor``

    Args:
        grad_avg: (G,) mean position-gradient norms since the last call.

    Returns:
        (new_scene, src_rows): ``src_rows[i]`` is the parent row of new row
        ``i`` (numpy int), which ``AdamState.remap`` takes.
    """
    g = scene.means.shape[0]
    opac = torch.sigmoid(scene.opacity_logits).cpu().numpy()
    grad_avg = np.asarray(torch.as_tensor(grad_avg).cpu())
    scales = torch.exp(scene.log_scales).cpu().numpy().max(-1)

    keep = opac >= min_opacity
    high = grad_avg > grad_threshold
    clone = keep & high & (scales <= split_scale)
    split = keep & high & (scales > split_scale)
    stay = keep & ~split

    idx = np.arange(g)
    src_rows = np.concatenate(
        [idx[stay], idx[clone], np.repeat(idx[split], 2)])
    if len(src_rows) > max_gaussians:
        src_rows = src_rows[:max_gaussians]
    is_split_child = np.zeros(len(src_rows), bool)
    is_split_child[int(stay.sum() + clone.sum()):] = True

    device = scene.means.device
    src = torch.as_tensor(src_rows, dtype=torch.long, device=device)
    new = GaussianScene(*(t[src] for t in scene))
    if is_split_child.any():
        child = torch.as_tensor(is_split_child, device=device)[:, None]
        eps = torch.randn(new.means.shape, generator=generator,
                          device=device)
        R = quat_to_rotmat(new.quats)
        offs = torch.einsum("gij,gj->gi", R, eps * torch.exp(new.log_scales))
        shrink = torch.log(torch.tensor(split_factor, device=device))
        new = new._replace(
            means=torch.where(child, new.means + offs, new.means),
            log_scales=torch.where(child, new.log_scales - shrink,
                                   new.log_scales))
    return new, src_rows


def reset_opacity(scene: GaussianScene, value: float = 0.01) -> GaussianScene:
    """Periodic opacity reset (gsplat behaviour): clamp opacity down so
    pruning can reconsider every Gaussian."""
    cap = torch.log(torch.tensor(value / (1 - value),
                                 device=scene.opacity_logits.device))
    return scene._replace(opacity_logits=torch.minimum(scene.opacity_logits,
                                                       cap))


def fit_scene_adaptive(target: torch.Tensor, cam: Camera, n_init: int = 64,
                       steps: int = 600, densify_every: int = 150,
                       densify_until: Optional[int] = None, lr: float = 2e-2,
                       seed: int = 0, extent: float = 1.0,
                       max_gaussians: int = 50_000, renderer: str = "dense",
                       **densify_kw) -> Tuple[GaussianScene, float]:
    """Fit with adaptive density control on the target's device: train,
    densify / prune every ``densify_every`` steps until ``densify_until``,
    the Adam moments remapped to the new rows (children inherit their
    parent's). One generator seeded with ``seed`` draws the initial scene
    and every split's noise."""
    densify_until = densify_until or (steps * 2) // 3
    gen = torch.Generator(device=target.device).manual_seed(seed)
    scene = init_scene(gen, n_init, extent)
    tx, step = make_train_step_with_stats(cam, lr, renderer=renderer)
    opt_state = tx.init(scene)

    grad_accum = torch.zeros(n_init, device=target.device)
    n_since = 0
    loss = torch.tensor(math.inf)
    for i in range(steps):
        scene, opt_state, loss, gnorm = step(scene, opt_state, target)
        grad_accum = grad_accum + gnorm
        n_since += 1
        if i < densify_until and (i + 1) % densify_every == 0:
            scene, src = densify_and_prune(
                scene, grad_accum / max(n_since, 1), gen,
                max_gaussians=max_gaussians, **densify_kw)
            opt_state = opt_state.remap(src)
            grad_accum = torch.zeros(scene.means.shape[0],
                                     device=target.device)
            n_since = 0
    return scene, float(loss)
