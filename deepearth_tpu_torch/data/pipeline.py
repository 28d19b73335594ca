"""Spec-stack data pipeline: CSV validation, preprocessing, context sampling
(reference: SPECIFICATIONS.MD:359-1063 — DatasetLoader, DataPreprocessor,
ContextSamplingEngine); the port's copy of ``deepearth_tpu/data/pipeline.py``
(numpy, with pandas and sklearn imported where they are used).

* :class:`DatasetLoader` validates observation CSVs in three coordinate
  systems (geodetic lat/lon/alt, ECEF xyz, normalized) and two temporal
  formats (ISO datetime strings, normalized floats).
* :class:`DataPreprocessor` removes coordinate outliers, converts to ECEF and
  normalizes against the dataset bounding box, and builds per-modality
  statistics / categorical vocabularies.
* :class:`ContextSamplingEngine` samples spatial / temporal / ecological
  neighbourhoods per anchor observation (reference context_size=32). The
  reference specifies FAISS; sklearn's exact NearestNeighbors serves the
  same queries at this dataset scale (33k observations) without the
  dependency.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..geospatial import GeospatialConverter, geodetic_to_ecef
from ..utils.logging import get_logger

logger = get_logger("Pipeline")

COORD_SYSTEMS = ("geodetic", "ecef", "normalized")
REQUIRED_GEODETIC = ("latitude", "longitude")


@dataclass
class ValidationReport:
    ok: bool
    coordinate_system: str
    temporal_format: str
    n_rows: int
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)


class DatasetLoader:
    """CSV loading + schema validation (reference: SPECIFICATIONS.MD:359+)."""

    def load_csv(self, path: str):
        import pandas as pd

        df = pd.read_csv(path)
        report = self.validate(df)
        if not report.ok:
            raise ValueError(f"invalid dataset: {report.errors}")
        return df, report

    def validate(self, df) -> ValidationReport:
        errors: List[str] = []
        warnings: List[str] = []
        cols = set(df.columns)

        # coordinate system detection
        if {"latitude", "longitude"} <= cols:
            system = "geodetic"
            lat, lon = df["latitude"], df["longitude"]
            if not ((lat >= -90) & (lat <= 90)).all():
                errors.append("latitude out of [-90, 90]")
            if not ((lon >= -180) & (lon <= 180)).all():
                errors.append("longitude out of [-180, 180]")
        elif {"x", "y", "z"} <= cols:
            r = np.sqrt(df["x"] ** 2 + df["y"] ** 2 + df["z"] ** 2)
            if ((r > 6.2e6) & (r < 6.5e6)).all():
                system = "ecef"
            elif ((df[["x", "y", "z"]] >= 0) & (df[["x", "y", "z"]] <= 1)).all().all():
                system = "normalized"
            else:
                system = "ecef"
                warnings.append("xyz radii outside Earth range; assuming ECEF")
        else:
            return ValidationReport(
                False, "unknown", "unknown", len(df),
                ["no recognizable coordinate columns "
                 "(need latitude/longitude or x/y/z)"],
            )

        # temporal format detection
        if "timestamp" in cols or "datetime" in cols:
            col = "timestamp" if "timestamp" in cols else "datetime"
            sample = df[col].iloc[0] if len(df) else None
            if isinstance(sample, str):
                temporal = "iso_datetime"
                try:
                    _dt.datetime.fromisoformat(sample)
                except ValueError:
                    errors.append(f"unparseable datetime {sample!r}")
            else:
                vals = df[col].astype(float)
                if ((vals >= 0) & (vals <= 1)).all():
                    temporal = "normalized"
                else:
                    temporal = "unix_epoch"
        elif "year" in cols:
            temporal = "year_month_day"
        else:
            temporal = "none"
            warnings.append("no temporal column; time defaults to 0.5")

        if df.isna().any().any():
            n = int(df.isna().any(axis=1).sum())
            warnings.append(f"{n} rows contain NaNs")

        return ValidationReport(
            ok=not errors,
            coordinate_system=system,
            temporal_format=temporal,
            n_rows=len(df),
            errors=errors,
            warnings=warnings,
        )


@dataclass
class ModalityStats:
    mean: np.ndarray
    std: np.ndarray
    vocab: Optional[List] = None  # categorical modalities


class DataPreprocessor:
    """Outlier removal + ECEF normalization + per-modality stats
    (reference: SPECIFICATIONS.MD DataPreprocessor)."""

    def __init__(self, outlier_sigma: float = 5.0):
        self.outlier_sigma = outlier_sigma
        self.converter = GeospatialConverter()
        self.modality_stats: Dict[str, ModalityStats] = {}

    def remove_outliers(self, df, columns: Sequence[str]):
        keep = np.ones(len(df), bool)
        for c in columns:
            v = df[c].to_numpy(np.float64)
            mu, sd = np.nanmean(v), np.nanstd(v) + 1e-12
            keep &= np.abs(v - mu) <= self.outlier_sigma * sd
        dropped = int((~keep).sum())
        if dropped:
            logger.info(f"outlier removal dropped {dropped} rows")
        return df[keep].reset_index(drop=True)

    def normalize_coordinates(self, df) -> np.ndarray:
        """geodetic columns → ECEF → normalized [0,1]^3 via the converter."""
        geo = np.stack(
            [
                df["latitude"].to_numpy(np.float64),
                df["longitude"].to_numpy(np.float64),
                df.get("altitude", 0.0 * df["latitude"]).to_numpy(np.float64),
            ],
            axis=-1,
        )
        xyz = geodetic_to_ecef(geo)
        return self.converter.xyz_to_norm(xyz).astype(np.float32)

    def fit_modality(self, name: str, values: np.ndarray, categorical=False):
        if categorical:
            vocab = sorted(set(np.asarray(values).tolist()))
            self.modality_stats[name] = ModalityStats(
                mean=np.zeros(1), std=np.ones(1), vocab=vocab
            )
        else:
            v = np.asarray(values, np.float64).reshape(len(values), -1)
            self.modality_stats[name] = ModalityStats(
                mean=v.mean(0), std=v.std(0) + 1e-8
            )
        return self.modality_stats[name]

    def transform_modality(self, name: str, values: np.ndarray) -> np.ndarray:
        st = self.modality_stats[name]
        if st.vocab is not None:
            lut = {v: i for i, v in enumerate(st.vocab)}
            return np.asarray([lut[v] for v in values], np.int32)
        v = np.asarray(values, np.float64).reshape(len(values), -1)
        return ((v - st.mean) / st.std).astype(np.float32)


class ContextSamplingEngine:
    """Neighbourhood sampling around anchor observations
    (reference: SPECIFICATIONS.MD ContextSamplingEngine, context_size=32)."""

    def __init__(
        self,
        xyzt: np.ndarray,
        species: Optional[np.ndarray] = None,
        context_size: int = 32,
    ):
        self.xyzt = np.asarray(xyzt, np.float32)
        self.species = species
        self.context_size = context_size
        from sklearn.neighbors import NearestNeighbors

        self._spatial = NearestNeighbors().fit(self.xyzt[:, :3])
        self._temporal = NearestNeighbors().fit(self.xyzt[:, 3:4])
        if species is not None:
            self._by_species: Dict[int, np.ndarray] = {}
            for s in np.unique(species):
                self._by_species[int(s)] = np.nonzero(species == s)[0]

    def _k(self, k: Optional[int]) -> int:
        return min(k or self.context_size, len(self.xyzt))

    def spatial_neighbors(self, anchor_idx: int, k: Optional[int] = None):
        k = self._k(k)
        _, idx = self._spatial.kneighbors(
            self.xyzt[anchor_idx : anchor_idx + 1, :3], n_neighbors=k
        )
        return idx[0]

    def temporal_neighbors(self, anchor_idx: int, k: Optional[int] = None):
        k = self._k(k)
        _, idx = self._temporal.kneighbors(
            self.xyzt[anchor_idx : anchor_idx + 1, 3:4], n_neighbors=k
        )
        return idx[0]

    def ecological_neighbors(
        self, anchor_idx: int, k: Optional[int] = None, rng=None
    ):
        """Same-species co-occurrences (reference 'ecological' sampling)."""
        if self.species is None:
            raise ValueError("species labels required for ecological sampling")
        k = self._k(k)
        pool = self._by_species[int(self.species[anchor_idx])]
        rng = rng or np.random.default_rng(0)
        if len(pool) <= k:
            return pool
        return rng.choice(pool, size=k, replace=False)

    def sample_context(
        self, anchor_idx: int, mix=(0.5, 0.25, 0.25), rng=None
    ) -> np.ndarray:
        """Mixed spatial/temporal/ecological context of context_size indices."""
        rng = rng or np.random.default_rng(0)
        ks = [int(round(m * self.context_size)) for m in mix]
        ks[0] = self.context_size - sum(ks[1:])
        parts = [self.spatial_neighbors(anchor_idx, ks[0])]
        if ks[1]:
            parts.append(self.temporal_neighbors(anchor_idx, ks[1]))
        if ks[2] and self.species is not None:
            parts.append(self.ecological_neighbors(anchor_idx, ks[2], rng))
        ctx = np.concatenate(parts)[: self.context_size]
        if len(ctx) < self.context_size:  # pad by repeating
            ctx = np.concatenate(
                [ctx, rng.choice(ctx, self.context_size - len(ctx))]
            )
        return ctx
