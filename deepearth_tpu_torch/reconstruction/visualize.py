"""Headless visualization: observation maps, point clouds, splat renders
(the port's copy of ``deepearth_tpu/reconstruction/visualize.py``; matplotlib
is imported at the first plot, so the module imports without it)
(reference: reconstruction/interactive_visualizer.py — an interactive GUI;
this environment is headless, so figures render to PNG via matplotlib's Agg
backend instead)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_observation_map(
    lat: np.ndarray,
    lon: np.ndarray,
    color_by: Optional[np.ndarray] = None,
    path: str = "observations.png",
    title: str = "Observations",
) -> str:
    """Scatter observations over lon/lat, optionally colored by a label."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6), dpi=120)
    sc = ax.scatter(lon, lat, c=color_by, s=6, cmap="tab20", alpha=0.8)
    if color_by is not None:
        fig.colorbar(sc, ax=ax, shrink=0.8)
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_point_cloud(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    path: str = "cloud.png",
    elev: float = 30.0,
    azim: float = 45.0,
) -> str:
    """3D scatter of an (N, 3) point cloud."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 8), dpi=120)
    ax = fig.add_subplot(projection="3d")
    c = colors / 255.0 if colors is not None and colors.max() > 1 else colors
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=c, s=2)
    ax.view_init(elev=elev, azim=azim)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def save_render(image: np.ndarray, path: str = "render.png") -> str:
    """Save an (H, W, 3) float render (e.g. from gaussian_splat.render)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    ax.imshow(np.clip(np.asarray(image), 0, 1))
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_attention_map(
    attention: np.ndarray, path: str = "attention.png"
) -> str:
    """Heatmap of a (H, W) spatial attention/saliency grid."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5), dpi=120)
    im = ax.imshow(attention, cmap="viridis")
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title("spatial attention")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
