"""HTTP client for the dashboard data service: the port's copy of
``deepearth_tpu/serving/client.py``
(reference: training's Flask-API access path,
training/scripts/benchmark_data_access.py + encoders/language/client.py)."""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Any, Dict, Sequence

import numpy as np


class DashboardClient:
    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> Dict[str, Any]:
        with urllib.request.urlopen(
            self.base_url + path, timeout=self.timeout
        ) as r:
            return json.loads(r.read())

    def _post(self, path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    # -- routes --------------------------------------------------------------- #

    def health(self) -> Dict[str, Any]:
        return self._get("/api/health")

    def observations(self, bbox=None, limit: int = 1000) -> Dict[str, Any]:
        q = f"?limit={limit}"
        if bbox is not None:
            q += "&bbox=" + ",".join(str(x) for x in bbox)
        return self._get("/api/observations" + q)

    def observation(self, gbif_id: int) -> Dict[str, Any]:
        return self._get(f"/api/observation/{gbif_id}")

    def species(self) -> Dict[str, Any]:
        return self._get("/api/species")

    def training_batch(self, observation_ids: Sequence[int]) -> Dict[str, Any]:
        return self._post(
            "/api/training/batch", {"observation_ids": list(observation_ids)}
        )

    def projection(self, embeddings, n_components: int = 3) -> np.ndarray:
        out = self._post(
            "/api/projection",
            {"embeddings": np.asarray(embeddings).tolist(),
             "n_components": n_components},
        )
        return np.asarray(out["projection"], np.float32)

    def predict(self, location, time_=None, data=None) -> np.ndarray:
        out = self._post(
            "/api/predict",
            {"location": list(location), "time": time_, "data": data or {}},
        )
        return np.asarray(out["embedding"], np.float32)

    # -- benchmark (reference: training/scripts/benchmark_data_access.py) ----- #

    def benchmark_training_batch(
        self, observation_ids: Sequence[int], runs: int = 10
    ) -> Dict[str, float]:
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            self.training_batch(observation_ids)
            times.append(time.perf_counter() - t0)
        t = np.asarray(times) * 1000
        return {
            "p50_ms": float(np.percentile(t, 50)),
            "p90_ms": float(np.percentile(t, 90)),
            "mean_ms": float(t.mean()),
            "ms_per_observation": float(t.mean() / len(observation_ids)),
        }
