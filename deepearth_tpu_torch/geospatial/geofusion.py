"""GeoFusion RTK data loading (reference: geospatial/geofusion.py:48+); the
port's copy of ``deepearth_tpu/geospatial/geofusion.py``.

CSV schema: time, image, latitude, longitude, altitude, yaw, pitch, roll,
xyAccuracy, zAccuracy.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .structures import GeoOrientation


@dataclass
class GeoFusionEntry:
    """Single RTK record: pose + accuracy + image reference."""

    timestamp: float
    image_name: str
    lat: float
    lon: float
    alt: float
    yaw: float
    pitch: float
    roll: float
    latitudinal_accuracy: float
    longitudinal_accuracy: float
    altitudinal_accuracy: float

    @property
    def orientation(self) -> GeoOrientation:
        return GeoOrientation(yaw=self.yaw, pitch=self.pitch, roll=self.roll)

    @property
    def position(self) -> List[float]:
        return [self.lat, self.lon, self.alt]


class GeoFusionDataLoader:
    """Loads RTK pose CSVs and hands numpy arrays to a GeospatialConverter."""

    def __init__(self, converter, data_dir: Optional[str] = None):
        self.converter = converter
        self.data_dir = data_dir or os.path.join("data", "testing")
        self.entries: List[GeoFusionEntry] = []

    def load_csv(self, filename: str = "geofusion.csv") -> None:
        filepath = (
            filename if os.path.isabs(filename) else os.path.join(self.data_dir, filename)
        )
        self.entries = []
        with open(filepath, newline="") as f:
            for row in csv.DictReader(f):
                self.entries.append(
                    GeoFusionEntry(
                        timestamp=float(row["time"]),
                        image_name=f"{row['image']}.jpg",
                        lat=float(row["latitude"]),
                        lon=float(row["longitude"]),
                        alt=float(row["altitude"]),
                        yaw=float(row["yaw"]),
                        pitch=float(row["pitch"]),
                        roll=float(row["roll"]),
                        latitudinal_accuracy=float(row["xyAccuracy"]),
                        longitudinal_accuracy=float(row["xyAccuracy"]),
                        altitudinal_accuracy=float(row["zAccuracy"]),
                    )
                )

    def _require_entries(self):
        if not self.entries:
            raise RuntimeError("No data loaded. Call load_csv() first.")

    def get_locations(self) -> np.ndarray:
        self._require_entries()
        return np.array([e.position for e in self.entries], dtype=np.float64)

    def get_orientations(self) -> np.ndarray:
        self._require_entries()
        return np.array(
            [[e.yaw, e.pitch, e.roll] for e in self.entries], dtype=np.float64
        )

    def get_accuracy(self) -> np.ndarray:
        self._require_entries()
        return np.array(
            [[e.latitudinal_accuracy, e.altitudinal_accuracy] for e in self.entries],
            dtype=np.float64,
        )

    def convert_all(self) -> Tuple[np.ndarray, np.ndarray]:
        self._require_entries()
        return self.get_locations(), self.get_orientations()
