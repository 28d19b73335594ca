"""Geospatial data structures (reference: geospatial/data_structures.py:46+);
the port's copy of ``deepearth_tpu/geospatial/structures.py``.

numpy-native equivalents of the reference's torch-based types.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class BoundingBox:
    """3D axis-aligned bounding box used for coordinate normalization."""

    min_x: float
    min_y: float
    min_z: float
    max_x: float
    max_y: float
    max_z: float

    @property
    def min_point(self) -> np.ndarray:
        return np.array([self.min_x, self.min_y, self.min_z], dtype=np.float64)

    @property
    def max_point(self) -> np.ndarray:
        return np.array([self.max_x, self.max_y, self.max_z], dtype=np.float64)

    @property
    def span(self) -> np.ndarray:
        return self.max_point - self.min_point

    @classmethod
    def from_points(cls, points: np.ndarray) -> "BoundingBox":
        pts = np.asarray(points, dtype=np.float64).reshape(-1, points.shape[-1])
        mn = pts.min(axis=0)
        mx = pts.max(axis=0)
        return cls(mn[0], mn[1], mn[2], mx[0], mx[1], mx[2])

    def union(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(
            min(self.min_x, other.min_x),
            min(self.min_y, other.min_y),
            min(self.min_z, other.min_z),
            max(self.max_x, other.max_x),
            max(self.max_y, other.max_y),
            max(self.max_z, other.max_z),
        )


@dataclass
class GeoOrientation:
    """Yaw/pitch/roll in degrees (aerospace sequence,
    reference: geospatial/data_structures.py:102-160)."""

    yaw: float
    pitch: float
    roll: float

    def to_radians(self) -> Tuple[float, float, float]:
        return (
            float(np.deg2rad(self.yaw)),
            float(np.deg2rad(self.pitch)),
            float(np.deg2rad(self.roll)),
        )

    def to_rotation_matrix(self) -> np.ndarray:
        """YPR → 3x3 rotation matrix, aerospace order Rz(yaw)·Ry(pitch)·Rx(roll).

        Matches geodesy.ypr_to_rotation / rotation_to_ypr so the two APIs
        round-trip. (The reference composed the factors in the reverse order
        in data_structures.py while its converter used the aerospace order —
        an internal inconsistency we do not reproduce.)
        """
        y, p, r = self.to_radians()
        cy, sy = np.cos(y), np.sin(y)
        cp, sp = np.cos(p), np.sin(p)
        cr, sr = np.cos(r), np.sin(r)
        Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        Ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
        Rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
        return Rz @ Ry @ Rx


@dataclass
class GeoPoint:
    """A single geodetic point with optional orientation."""

    lat: float
    lon: float
    alt: float
    orientation: Optional[GeoOrientation] = None


@dataclass
class CoordinateSet:
    """A point represented in all three coordinate spaces plus metadata
    (reference: geospatial/data_structures.py:177-235)."""

    lat: float
    lon: float
    alt: float
    x: float
    y: float
    z: float
    rel_x: float
    rel_y: float
    rel_z: float
    bbox: BoundingBox
    orientation: Optional[GeoOrientation] = None
    rotation_matrix: Optional[np.ndarray] = None
    timestamp: Optional[float] = None
    image_path: Optional[str] = None
    latitudinal_accuracy: Optional[float] = None
    longitudinal_accuracy: Optional[float] = None
    altitudinal_accuracy: Optional[float] = None
