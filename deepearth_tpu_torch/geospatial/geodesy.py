"""High-precision WGS-84 coordinate conversions (reference: geospatial/geo2xyz.py:60);
the port's copy of ``deepearth_tpu/geospatial/geodesy.py``.

Three coordinate spaces:
  A. Geodetic       — (lat, lon, alt) degrees / metres, WGS-84
  B. ECEF XYZ       — Earth-centred Cartesian, metres
  C. Normalised XYZ — each axis in [0, 1] w.r.t. a bounding box

All math is numpy float64 on the host (coordinate prep never runs on the
device), preserving the reference's sub-micrometer round-trip
guarantee via Bowring's iterative method.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np

from .structures import BoundingBox, CoordinateSet, GeoOrientation
from .utils import as_fp64, safe_div

# WGS-84 constants (reference: geospatial/geo2xyz.py:97-100)
WGS84_A = 6_378_137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = 2.0 * WGS84_F - WGS84_F * WGS84_F

# Fixed body→camera rotation: Rz(90°) (reference: geospatial/geo2xyz.py:208-212)
_R_BODY_CAM = np.array(
    [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=np.float64
)

_DTYPE_ORDER = {np.dtype(np.float16): 0, np.dtype(np.float32): 1, np.dtype(np.float64): 2}


def geodetic_to_ecef(geo: np.ndarray) -> np.ndarray:
    """(..., 3) (lat°, lon°, alt m) → (..., 3) ECEF metres."""
    geo = as_fp64(geo)
    lat = np.deg2rad(geo[..., 0])
    lon = np.deg2rad(geo[..., 1])
    alt = geo[..., 2]
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat ** 2)
    return np.stack(
        (
            (n + alt) * cos_lat * cos_lon,
            (n + alt) * cos_lat * sin_lon,
            (n * (1.0 - WGS84_E2) + alt) * sin_lat,
        ),
        axis=-1,
    )


def ecef_to_geodetic(xyz: np.ndarray, iterations: int = 5) -> np.ndarray:
    """(..., 3) ECEF metres → (..., 3) (lat°, lon°, alt m) via Bowring's method
    (reference: geospatial/geo2xyz.py:254-268)."""
    xyz = as_fp64(xyz)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    p = np.sqrt(x * x + y * y)
    lon = np.arctan2(y, x)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(iterations):
        s = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * s ** 2)
        lat = np.arctan2(z + WGS84_E2 * n * s, p)
    s = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * s ** 2)
    c = np.cos(lat)
    alt = np.where(np.abs(c) < 1e-12, np.abs(z) - n * (1.0 - WGS84_E2), p / c - n)
    return np.stack((np.rad2deg(lat), np.rad2deg(lon), alt), axis=-1)


def ypr_to_rotation(orientation: np.ndarray) -> np.ndarray:
    """(..., 3) (yaw°, pitch°, roll°) → (..., 3, 3) body→NED rotation."""
    o = as_fp64(orientation)
    y, p, r = (np.deg2rad(o[..., i]) for i in range(3))
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    R = np.zeros(o.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def ned_to_ecef_rotation(geo: np.ndarray) -> np.ndarray:
    """(..., 3) geodetic → (..., 3, 3) NED→ECEF rotation (columns = N, E, D in
    ECEF; reference: geospatial/geo2xyz.py:187-201)."""
    g = as_fp64(geo)
    lat = np.deg2rad(g[..., 0])
    lon = np.deg2rad(g[..., 1])
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    R = np.zeros(g.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = -sin_lat * cos_lon
    R[..., 1, 0] = -sin_lat * sin_lon
    R[..., 2, 0] = cos_lat
    R[..., 0, 1] = -sin_lon
    R[..., 1, 1] = cos_lon
    R[..., 2, 1] = 0.0
    R[..., 0, 2] = -cos_lat * cos_lon
    R[..., 1, 2] = -cos_lat * sin_lon
    R[..., 2, 2] = -sin_lat
    return R


def rotation_to_ypr(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation → (..., 3) (yaw°, pitch°, roll°) aerospace sequence."""
    R = as_fp64(R)
    pitch = np.arcsin(-R[..., 2, 0])
    yaw = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    roll = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    return np.stack((np.rad2deg(yaw), np.rad2deg(pitch), np.rad2deg(roll)), axis=-1)


class GeospatialConverter:
    """Stateful converter with automatic bounding-box and precision management
    (reference: geospatial/geo2xyz.py:60-342).

    Tracks a running bounding box over the ECEF points it has seen and picks
    the smallest dtype that keeps normalized-coordinate error under 1 mm,
    auto-upgrading as the span grows (reference: geo2xyz.py:291-325).
    """

    def __init__(self, norm_dtype=np.float64):
        self._norm_user = np.dtype(norm_dtype)
        self._norm_eff = np.dtype(norm_dtype)
        self._bbox: Optional[BoundingBox] = None

    # -- bbox management ---------------------------------------------------- #

    @property
    def bbox(self) -> Optional[BoundingBox]:
        return self._bbox

    def reset_bbox(self) -> None:
        self._bbox = None

    @staticmethod
    def _best_dtype_for_span(span: np.ndarray):
        for dt in (np.float16, np.float32, np.float64):
            if np.all((span * np.finfo(dt).eps) / 2.0 <= 1e-3):
                return np.dtype(dt)
        return np.dtype(np.float64)

    def update_bbox(self, xyz: np.ndarray) -> None:
        new = BoundingBox.from_points(as_fp64(xyz))
        self._bbox = new if self._bbox is None else self._bbox.union(new)
        chosen = self._best_dtype_for_span(self._bbox.span)
        if _DTYPE_ORDER[chosen] >= _DTYPE_ORDER[self._norm_user]:
            self._norm_eff = chosen
        else:
            self._norm_eff = self._norm_user

    # -- conversions --------------------------------------------------------- #

    def geodetic_to_xyz(
        self,
        geo: np.ndarray,
        orientation: Optional[np.ndarray] = None,
        return_intermediates: bool = False,
    ):
        """Geodetic → ECEF; optionally also camera-to-ECEF rotation matrices."""
        geo = as_fp64(geo)
        xyz = geodetic_to_ecef(geo)
        R_ecef_cam = R_ned_body = R_ecef_ned = None
        if orientation is not None:
            R_ned_body = ypr_to_rotation(orientation)
            R_ecef_ned = ned_to_ecef_rotation(geo)
            R_ecef_body = R_ecef_ned @ R_ned_body
            R_ecef_cam = R_ecef_body @ _R_BODY_CAM
        if return_intermediates:
            return xyz, R_ecef_cam, R_ned_body, R_ecef_ned
        return xyz, R_ecef_cam

    def xyz_to_geodetic(
        self, xyz: np.ndarray, rotation_matrix: Optional[np.ndarray] = None
    ):
        geo = ecef_to_geodetic(xyz)
        if rotation_matrix is not None:
            return geo, rotation_to_ypr(rotation_matrix)
        return geo, None

    def xyz_to_norm(self, xyz: np.ndarray) -> np.ndarray:
        """ECEF → [0,1]^3 against the running bounding box."""
        self.update_bbox(xyz)
        norm64 = safe_div(as_fp64(xyz) - self._bbox.min_point, self._bbox.span)
        return norm64.astype(self._norm_eff)

    def norm_to_xyz(self, norm: np.ndarray) -> np.ndarray:
        """[0,1]^3 → ECEF. For reduced-precision inputs, nudges interior points
        by eps/2·span to counter truncation bias (reference: geo2xyz.py:334-342)."""
        if self._bbox is None:
            raise ValueError("no bounding box set; call xyz_to_norm first")
        norm = np.asarray(norm)
        if norm.dtype in (np.float16, np.float32):
            eps = np.finfo(norm.dtype).eps
            half = (eps / 2.0) * self._bbox.span.reshape((1,) * (norm.ndim - 1) + (3,))
            interior = (norm > 0) & (norm < 1)
            norm = np.where(interior, norm + half.astype(norm.dtype), norm)
        return as_fp64(norm) * self._bbox.span + self._bbox.min_point

    # -- CSV IO --------------------------------------------------------------- #

    def export_coordinates(self, filepath: str, coordinates: List[CoordinateSet]) -> None:
        """CSV export with flexible metadata schema
        (reference: geospatial/geo2xyz.py:344-429)."""
        d = os.path.dirname(filepath)
        if d:
            os.makedirs(d, exist_ok=True)
        has_ts = any(c.timestamp is not None for c in coordinates)
        has_img = any(c.image_path is not None for c in coordinates)
        has_acc = any(c.latitudinal_accuracy is not None for c in coordinates)
        has_ori = any(c.orientation is not None for c in coordinates)
        has_rot = has_ori and any(c.rotation_matrix is not None for c in coordinates)

        headers = [
            "Latitude", "Longitude", "Altitude",
            "Global_X", "Global_Y", "Global_Z",
            "Relative_X", "Relative_Y", "Relative_Z",
            "BBox_Min_X", "BBox_Min_Y", "BBox_Min_Z",
            "BBox_Max_X", "BBox_Max_Y", "BBox_Max_Z",
        ]
        if has_ts:
            headers.append("Timestamp")
        if has_img:
            headers.append("Image_Path")
        if has_acc:
            headers += [
                "Latitudinal_Accuracy_Meters",
                "Longitudinal_Accuracy_Meters",
                "Altitudinal_Accuracy_Meters",
            ]
        if has_ori:
            headers += ["Yaw", "Pitch", "Roll"]
            if has_rot:
                headers += [f"R{i}{j}" for i in range(1, 4) for j in range(1, 4)]

        with open(filepath, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(headers)
            for c in coordinates:
                row = [
                    f"{c.lat:.14f}", f"{c.lon:.14f}", f"{c.alt:.11f}",
                    f"{c.x:.14f}", f"{c.y:.14f}", f"{c.z:.14f}",
                    f"{c.rel_x:.14f}", f"{c.rel_y:.14f}", f"{c.rel_z:.14f}",
                    f"{c.bbox.min_x:.14f}", f"{c.bbox.min_y:.14f}", f"{c.bbox.min_z:.14f}",
                    f"{c.bbox.max_x:.14f}", f"{c.bbox.max_y:.14f}", f"{c.bbox.max_z:.14f}",
                ]
                if has_ts:
                    row.append(f"{c.timestamp:.6f}" if c.timestamp is not None else "")
                if has_img:
                    row.append(c.image_path or "")
                if has_acc:
                    for v in (c.latitudinal_accuracy, c.longitudinal_accuracy,
                              c.altitudinal_accuracy):
                        row.append(f"{v:.6f}" if v is not None else "")
                if has_ori:
                    if c.orientation is not None:
                        row += [
                            f"{c.orientation.yaw:.14f}",
                            f"{c.orientation.pitch:.14f}",
                            f"{c.orientation.roll:.14f}",
                        ]
                    else:
                        row += ["", "", ""]
                    if has_rot:
                        if c.rotation_matrix is not None:
                            row += [f"{v:.14f}" for v in np.asarray(c.rotation_matrix).flatten()]
                        else:
                            row += [""] * 9
                w.writerow(row)

    def import_coordinates(self, filepath: str) -> List[CoordinateSet]:
        """CSV import matching :meth:`export_coordinates`'s schema."""
        out: List[CoordinateSet] = []
        with open(filepath, "r", newline="") as f:
            r = csv.reader(f)
            headers = next(r)

            def idx(name):
                return headers.index(name) if name in headers else None

            ts_i, img_i = idx("Timestamp"), idx("Image_Path")
            acc_i = idx("Latitudinal_Accuracy_Meters")
            yaw_i, pitch_i, roll_i = idx("Yaw"), idx("Pitch"), idx("Roll")
            r11_i = idx("R11")

            for row in r:
                vals = [float(x) if x else None for x in row[:15]]
                ts = float(row[ts_i]) if ts_i is not None and row[ts_i] else None
                img = row[img_i] if img_i is not None and row[img_i] else None
                accs = [None, None, None]
                if acc_i is not None:
                    accs = [
                        float(row[acc_i + k]) if row[acc_i + k] else None
                        for k in range(3)
                    ]
                ori = None
                if yaw_i is not None and row[yaw_i] and row[pitch_i] and row[roll_i]:
                    ori = GeoOrientation(
                        float(row[yaw_i]), float(row[pitch_i]), float(row[roll_i])
                    )
                rot = None
                if r11_i is not None and all(row[r11_i + k] for k in range(9)):
                    rot = np.array(
                        [float(row[r11_i + k]) for k in range(9)], dtype=np.float64
                    ).reshape(3, 3)
                out.append(
                    CoordinateSet(
                        lat=vals[0], lon=vals[1], alt=vals[2],
                        x=vals[3], y=vals[4], z=vals[5],
                        rel_x=vals[6], rel_y=vals[7], rel_z=vals[8],
                        bbox=BoundingBox(*vals[9:15]),
                        orientation=ori,
                        rotation_matrix=rot,
                        timestamp=ts,
                        image_path=img,
                        latitudinal_accuracy=accs[0],
                        longitudinal_accuracy=accs[1],
                        altitudinal_accuracy=accs[2],
                    )
                )
        return out
