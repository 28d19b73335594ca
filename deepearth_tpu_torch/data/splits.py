"""Spatial / temporal train-test split generation: the port's copy of
``deepearth_tpu/data/splits.py`` (numpy only)
(reference: training/scripts/create_train_test_split.py:1-541).

Spatial holdout: k circular carve-out regions of radius r km with pairwise
centre separation >= min_separation km; temporal holdout: all observations in
the holdout year(s).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

EARTH_RADIUS_KM = 6371.0


def haversine_km(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Great-circle distance in km (vectorized, degrees in)."""
    lat1, lon1, lat2, lon2 = map(np.deg2rad, (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


@dataclass
class SplitConfig:
    n_spatial_regions: int = 5
    region_radius_km: float = 10.0
    min_separation_km: float = 15.0
    holdout_years: Tuple[int, ...] = (2025,)
    seed: int = 0


def create_spatial_temporal_split(
    lat: np.ndarray,
    lon: np.ndarray,
    year: np.ndarray,
    cfg: Optional[SplitConfig] = None,
) -> Dict[str, object]:
    """Returns a split dict mirroring training/config/central_florida_split.json:
    train / spatial_test / temporal_test index arrays + region centres."""
    cfg = cfg or SplitConfig()
    rng = np.random.default_rng(cfg.seed)
    n = len(lat)

    # pick spatial carve-out centres with rejection sampling
    centres: List[Tuple[float, float]] = []
    candidates = rng.permutation(n)
    for i in candidates:
        c = (float(lat[i]), float(lon[i]))
        if all(
            haversine_km(c[0], c[1], c2[0], c2[1]) >= cfg.min_separation_km
            for c2 in centres
        ):
            centres.append(c)
        if len(centres) >= cfg.n_spatial_regions:
            break

    spatial_test = np.zeros(n, dtype=bool)
    for clat, clon in centres:
        spatial_test |= haversine_km(lat, lon, clat, clon) <= cfg.region_radius_km

    temporal_test = np.isin(year, np.asarray(cfg.holdout_years))
    train = ~spatial_test & ~temporal_test

    return {
        "train_idx": np.nonzero(train)[0],
        "spatial_test_idx": np.nonzero(spatial_test & ~temporal_test)[0],
        "temporal_test_idx": np.nonzero(temporal_test)[0],
        "region_centres": centres,
        "config": cfg,
    }


def save_split(split: Dict[str, object], path: str) -> None:
    cfg = split["config"]
    payload = {
        "train_idx": np.asarray(split["train_idx"]).tolist(),
        "spatial_test_idx": np.asarray(split["spatial_test_idx"]).tolist(),
        "temporal_test_idx": np.asarray(split["temporal_test_idx"]).tolist(),
        "region_centres": [list(c) for c in split["region_centres"]],
        "config": {
            "n_spatial_regions": cfg.n_spatial_regions,
            "region_radius_km": cfg.region_radius_km,
            "min_separation_km": cfg.min_separation_km,
            "holdout_years": list(cfg.holdout_years),
            "seed": cfg.seed,
        },
    }
    with open(path, "w") as f:
        json.dump(payload, f)


def load_split(path: str) -> Dict[str, object]:
    with open(path) as f:
        payload = json.load(f)
    cfg = SplitConfig(
        n_spatial_regions=payload["config"]["n_spatial_regions"],
        region_radius_km=payload["config"]["region_radius_km"],
        min_separation_km=payload["config"]["min_separation_km"],
        holdout_years=tuple(payload["config"]["holdout_years"]),
        seed=payload["config"]["seed"],
    )
    return {
        "train_idx": np.asarray(payload["train_idx"], np.int64),
        "spatial_test_idx": np.asarray(payload["spatial_test_idx"], np.int64),
        "temporal_test_idx": np.asarray(payload["temporal_test_idx"], np.int64),
        "region_centres": [tuple(c) for c in payload["region_centres"]],
        "config": cfg,
    }
