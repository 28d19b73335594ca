"""Point-cloud utilities: depth-map unprojection and transforms (the
port's copy of ``deepearth_tpu/reconstruction/point_cloud.py``)
(reference: reconstruction/point_cloud_utils.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .geofusion_dataset import CameraIntrinsics


def unproject_depth(
    depth: np.ndarray,
    intrinsics: CameraIntrinsics,
    stride: int = 1,
    max_depth: Optional[float] = None,
) -> np.ndarray:
    """Depth map (H, W) metres → camera-frame points (M, 3).

    Pixels with non-positive (or > max_depth) depth are dropped.
    """
    h, w = depth.shape[:2]
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    d = depth[::stride, ::stride].astype(np.float64)
    valid = d > 0
    if max_depth is not None:
        valid &= d <= max_depth
    xs, ys, d = xs[valid], ys[valid], d[valid]
    x = (xs - intrinsics.cx) / intrinsics.fx * d
    y = (ys - intrinsics.cy) / intrinsics.fy * d
    return np.stack([x, y, d], axis=-1)


def transform_points(
    points: np.ndarray, rotation: np.ndarray, translation: np.ndarray
) -> np.ndarray:
    """(M, 3) camera-frame → world frame: R @ p + t."""
    return points @ np.asarray(rotation, np.float64).T + np.asarray(
        translation, np.float64
    )


def depth_to_world_cloud(
    depth: np.ndarray,
    intrinsics: CameraIntrinsics,
    rotation_cam_to_world: np.ndarray,
    position_world: np.ndarray,
    stride: int = 4,
    max_depth: Optional[float] = None,
) -> np.ndarray:
    """One call: depth map + pose → world-frame point cloud (M, 3)."""
    pts = unproject_depth(depth, intrinsics, stride, max_depth)
    return transform_points(pts, rotation_cam_to_world, position_world)


def voxel_downsample(
    points: np.ndarray, voxel_size: float
) -> np.ndarray:
    """Average points within voxels of the given size."""
    keys = np.floor(points / voxel_size).astype(np.int64)
    # lexicographic unique
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros((inverse.max() + 1, 3))
    counts = np.zeros(inverse.max() + 1)
    np.add.at(sums, inverse, points)
    np.add.at(counts, inverse, 1)
    return sums / counts[:, None]


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Write an ASCII PLY point cloud."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            line = f"{points[i, 0]:.6f} {points[i, 1]:.6f} {points[i, 2]:.6f}"
            if colors is not None:
                c = colors[i].astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read an ASCII PLY written by :func:`save_ply`."""
    with open(path) as f:
        n = 0
        has_color = False
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.startswith("property uchar red"):
                has_color = True
            if line == "end_header":
                break
        pts = np.zeros((n, 3))
        cols = np.zeros((n, 3), np.uint8) if has_color else None
        for i in range(n):
            vals = f.readline().split()
            pts[i] = [float(v) for v in vals[:3]]
            if has_color:
                cols[i] = [int(v) for v in vals[3:6]]
    return pts, cols
