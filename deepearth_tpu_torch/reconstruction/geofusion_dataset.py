"""GeoFusion reconstruction dataset: RTK-posed imagery + depth (the
port's copy of ``deepearth_tpu/reconstruction/geofusion_dataset.py``, over
the port's ``geospatial``)
(reference: reconstruction/geofusion_dataset.py:33-456).

Loads RTK pose CSVs through the geospatial layer, associates image / depth
files, computes camera-to-ECEF extrinsics and normalized-space poses, and
yields numpy frames for reconstruction pipelines.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..geospatial import GeoFusionDataLoader, GeospatialConverter


@dataclass
class CameraIntrinsics:
    """Pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )


@dataclass
class Frame:
    """One posed image: paths + pose in ECEF and normalized space."""

    image_name: str
    image_path: Optional[str]
    depth_path: Optional[str]
    timestamp: float
    position_ecef: np.ndarray  # (3,)
    position_norm: np.ndarray  # (3,) in [0,1]^3
    rotation_cam_to_ecef: np.ndarray  # (3,3)
    accuracy_xy_m: float
    accuracy_z_m: float


class GeoFusionDataset:
    """RTK CSV + image/depth directories → posed frames."""

    def __init__(
        self,
        pose_csv: str,
        image_dir: Optional[str] = None,
        depth_dir: Optional[str] = None,
        intrinsics: Optional[CameraIntrinsics] = None,
    ):
        self.converter = GeospatialConverter()
        loader = GeoFusionDataLoader(
            self.converter, data_dir=os.path.dirname(pose_csv) or "."
        )
        loader.load_csv(os.path.basename(pose_csv))
        self.entries = loader.entries
        self.image_dir = image_dir
        self.depth_dir = depth_dir
        self.intrinsics = intrinsics

        positions, orientations = loader.convert_all()
        xyz, rot = self.converter.geodetic_to_xyz(
            positions, orientation=orientations
        )
        norm = self.converter.xyz_to_norm(xyz)
        self._xyz = xyz
        self._norm = norm
        self._rot = rot

    def __len__(self) -> int:
        return len(self.entries)

    def _find(self, directory: Optional[str], name: str, exts) -> Optional[str]:
        if directory is None:
            return None
        stem = os.path.splitext(name)[0]
        for ext in exts:
            p = os.path.join(directory, stem + ext)
            if os.path.exists(p):
                return p
        return None

    def __getitem__(self, i: int) -> Frame:
        e = self.entries[i]
        return Frame(
            image_name=e.image_name,
            image_path=self._find(self.image_dir, e.image_name, (".jpg", ".png")),
            depth_path=self._find(self.depth_dir, e.image_name, (".tif", ".tiff", ".npy")),
            timestamp=e.timestamp,
            position_ecef=self._xyz[i],
            position_norm=np.asarray(self._norm[i], np.float64),
            rotation_cam_to_ecef=self._rot[i],
            accuracy_xy_m=e.latitudinal_accuracy,
            accuracy_z_m=e.altitudinal_accuracy,
        )

    def load_depth(self, i: int) -> Optional[np.ndarray]:
        f = self[i]
        if f.depth_path is None:
            return None
        if f.depth_path.endswith(".npy"):
            return np.load(f.depth_path)
        from PIL import Image

        return np.asarray(Image.open(f.depth_path), dtype=np.float32)

    def load_image(self, i: int) -> Optional[np.ndarray]:
        f = self[i]
        if f.image_path is None:
            return None
        from PIL import Image

        return np.asarray(Image.open(f.image_path))

    def poses(self) -> Dict[str, np.ndarray]:
        return {
            "positions_ecef": self._xyz,
            "positions_norm": np.asarray(self._norm, np.float64),
            "rotations": self._rot,
        }
