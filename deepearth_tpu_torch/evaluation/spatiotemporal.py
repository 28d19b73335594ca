"""Spatiotemporal evaluation metrics
(reference: evaluation/downstream_tasks.py:373-466); the port's copy of
``deepearth_tpu/evaluation/spatiotemporal.py``.

Moran's I spatial autocorrelation is implemented directly on a k-NN row-
standardized weight matrix (the reference shells out to pysal, which isn't
in this image); temporal consistency and spatially/temporally binned RMSE
match the reference definitions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def knn_weights(coords: np.ndarray, k: int = 8) -> np.ndarray:
    """Row-standardized k-nearest-neighbour weight matrix (N, N)."""
    n = coords.shape[0]
    d2 = np.sum((coords[:, None, :] - coords[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    k = min(k, n - 1)
    idx = np.argpartition(d2, k, axis=1)[:, :k]
    w = np.zeros((n, n))
    rows = np.repeat(np.arange(n), k)
    w[rows, idx.ravel()] = 1.0
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w


def morans_i(values: np.ndarray, coords: np.ndarray, k: int = 8) -> float:
    """Moran's I of ``values`` over spatial ``coords`` with k-NN weights.

    I = (n / sum_ij w_ij) * (sum_ij w_ij z_i z_j) / sum_i z_i^2
    """
    z = values - values.mean()
    w = knn_weights(coords, k)
    n = len(values)
    s0 = w.sum()
    num = float(z @ w @ z)
    den = float(z @ z) + 1e-12
    return (n / s0) * (num / den)


def temporal_consistency(
    values: np.ndarray, times: np.ndarray
) -> float:
    """Mean absolute difference between temporally adjacent values
    (lower = smoother in time)."""
    order = np.argsort(times)
    v = values[order]
    if len(v) < 2:
        return 0.0
    return float(np.mean(np.abs(np.diff(v, axis=0))))


def binned_rmse(
    pred: np.ndarray,
    true: np.ndarray,
    bin_by: np.ndarray,
    n_bins: int = 10,
) -> Dict[str, np.ndarray]:
    """RMSE per bin of ``bin_by`` (spatial coordinate or time)."""
    edges = np.quantile(bin_by, np.linspace(0, 1, n_bins + 1))
    edges[-1] += 1e-9
    which = np.clip(np.searchsorted(edges, bin_by, side="right") - 1, 0, n_bins - 1)
    rmse = np.full(n_bins, np.nan)
    counts = np.zeros(n_bins, dtype=int)
    err2 = (pred - true) ** 2
    if err2.ndim > 1:
        err2 = err2.mean(axis=tuple(range(1, err2.ndim)))
    for b in range(n_bins):
        m = which == b
        counts[b] = m.sum()
        if counts[b]:
            rmse[b] = np.sqrt(err2[m].mean())
    return {"bin_edges": edges, "rmse": rmse, "counts": counts}


class SpatiotemporalMetrics:
    """Bundle matching the reference class's surface
    (reference: evaluation/downstream_tasks.py:373)."""

    @staticmethod
    def morans_i(values, coords, k: int = 8) -> float:
        return morans_i(np.asarray(values), np.asarray(coords), k)

    @staticmethod
    def temporal_consistency(values, times) -> float:
        return temporal_consistency(np.asarray(values), np.asarray(times))

    @staticmethod
    def spatial_binned_rmse(pred, true, coords, axis: int = 0, n_bins: int = 10):
        return binned_rmse(
            np.asarray(pred), np.asarray(true), np.asarray(coords)[:, axis], n_bins
        )

    @staticmethod
    def temporal_binned_rmse(pred, true, times, n_bins: int = 10):
        return binned_rmse(np.asarray(pred), np.asarray(true), np.asarray(times), n_bins)


def haversine_like(lat, lon, clat, clon) -> np.ndarray:
    """Great-circle distance (km) from points to a single centre
    (delegates to the data layer's haversine_km — one implementation)."""
    from ..data.splits import haversine_km

    return haversine_km(np.asarray(lat), np.asarray(lon), clat, clon)
