"""Geospatial math layer (L0): WGS-84 conversions, structures, RTK loading;
the port's copy of ``deepearth_tpu/geospatial`` (numpy float64 only)."""

from .geodesy import (
    WGS84_A,
    WGS84_E2,
    WGS84_F,
    GeospatialConverter,
    ecef_to_geodetic,
    geodetic_to_ecef,
    ned_to_ecef_rotation,
    rotation_to_ypr,
    ypr_to_rotation,
)
from .geofusion import GeoFusionDataLoader, GeoFusionEntry
from .structures import BoundingBox, CoordinateSet, GeoOrientation, GeoPoint
from .utils import (
    human_unit,
    safe_div,
    wrap_lat,
    wrap_lat_array,
    wrap_lat_error,
    wrap_lon_error,
)

__all__ = [
    "WGS84_A",
    "WGS84_E2",
    "WGS84_F",
    "GeospatialConverter",
    "geodetic_to_ecef",
    "ecef_to_geodetic",
    "ypr_to_rotation",
    "ned_to_ecef_rotation",
    "rotation_to_ypr",
    "GeoFusionDataLoader",
    "GeoFusionEntry",
    "BoundingBox",
    "CoordinateSet",
    "GeoOrientation",
    "GeoPoint",
    "wrap_lat",
    "wrap_lat_array",
    "wrap_lat_error",
    "wrap_lon_error",
    "safe_div",
    "human_unit",
]
