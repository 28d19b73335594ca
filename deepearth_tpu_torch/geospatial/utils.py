"""Numeric helpers for geospatial math (reference: geospatial/utils.py:42+);
the port's copy of ``deepearth_tpu/geospatial/utils.py``.

All functions are numpy float64 — geospatial conversion is host-side data
preparation, never part of the device path, so full double
precision comes for free.
"""

from __future__ import annotations

import numpy as np


def as_fp64(x) -> np.ndarray:
    """Convert array-like to a float64 ndarray."""
    return np.asarray(x, dtype=np.float64)


def safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """Element-wise division mapping x/0 to 0.5 (degenerate-span normalization).

    Matches reference semantics (geospatial/utils.py:54-77): a zero span means
    every point shares that coordinate, so its normalized value is the box
    midpoint 0.5.
    """
    num = as_fp64(num)
    den = as_fp64(den)
    zero = np.abs(den) < 1e-9
    out = num / np.where(zero, 1.0, den)
    return np.where(zero, 0.5, out)


def wrap_lat(lat: float) -> float:
    """Normalize latitude to [-90, 90], reflecting over the poles."""
    lat = (lat + 180.0) % 360.0 - 180.0
    if lat > 90.0:
        lat = 180.0 - lat
    elif lat < -90.0:
        lat = -180.0 - lat
    return lat


def wrap_lat_array(lat: np.ndarray) -> np.ndarray:
    """Vectorized :func:`wrap_lat`."""
    lat = (as_fp64(lat) + 180.0) % 360.0 - 180.0
    lat = np.where(lat > 90.0, 180.0 - lat, lat)
    lat = np.where(lat < -90.0, -180.0 - lat, lat)
    return lat


def wrap_lon_error(lon1, lon2, lat) -> np.ndarray:
    """Longitude error accounting for -180≡180 wrapping and latitude scaling.

    Near the poles longitude differences are meaningless and map to zero
    (reference: geospatial/utils.py:92-103).
    """
    lon1, lon2, lat = as_fp64(lon1), as_fp64(lon2), as_fp64(lat)
    cos_lat = np.cos(np.deg2rad(lat))
    near_pole = np.abs(cos_lat) < 1e-7
    basic = np.abs(lon2 - lon1)
    wrapped = 360.0 - basic
    err = np.minimum(basic, wrapped)
    return np.where(near_pole, 0.0, err * cos_lat)


def wrap_lat_error(lat1, lat2) -> np.ndarray:
    """Latitude error accounting for polar equivalence
    (reference: geospatial/utils.py:106-128)."""
    l1 = wrap_lat_array(lat1)
    l2 = wrap_lat_array(lat2)
    pole1 = np.abs(np.abs(l1) - 90.0) < 1e-7
    pole2 = np.abs(np.abs(l2) - 90.0) < 1e-7
    err = np.abs(l2 - l1)
    return np.where(pole1 & pole2, 0.0, err)


def human_unit(val: float, unit: str) -> str:
    """Format a value with an SI prefix (reference: geospatial/utils.py:131-151)."""
    a = abs(val)
    suffix = " " + unit
    if a < 1e-12:
        return f"{val * 1e12:10.3f} p{suffix}"
    if a < 1e-9:
        return f"{val * 1e9:10.3f} n{suffix}"
    if a < 1e-6:
        return f"{val * 1e6:10.3f} µ{suffix}"
    if a < 1e-3:
        return f"{val * 1e3:10.3f} m{suffix}"
    return f"{val:13.3f}{suffix}"
