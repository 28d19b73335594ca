"""Dashboard/serving REST API: the PyTorch port of
``deepearth_tpu/serving/server.py``, the same routes over the port's data
layer, with ``/api/predict`` answered by the port's
:class:`deepearth_tpu_torch.api.DeepEarth`.

Re-implements the reference Flask dashboard surface
(reference: dashboard/deepearth_dashboard.py:94-438, 22 routes) on the
Python stdlib HTTP server. Routes:

  GET  /                               — minimal HTML frontend over the JSON API
  GET  /visualizer                     — the point-cloud viewer: not ported
                                         yet (a scene given to DataService
                                         raises; without one, 404)
  GET  /api/config                     — dataset/runtime config
  GET  /api/progress                   — training/loading progress polling
  GET  /api/health                     — health/status
  GET  /api/observations               — observation listing with bbox filter
  GET  /api/observation/<id>           — single observation
  GET  /api/species                    — species vocabulary + counts
  GET  /api/species_umap_colors        — stable RGB per species
  GET  /api/species/<id>/observations  — per-species observation list
  GET  /api/vision_embedding/<id>      — raw mmap-backed embedding (shape+stats)
  GET  /api/vision_embeddings/available— ids with stored vision embeddings
  GET  /api/attention_map/<id>         — spatial saliency grid
  GET  /api/features/<id>/attention    — alias of the above
  GET  /api/features/<id>/umap-rgb     — per-patch 3-D projection as RGB
  GET  /api/features/<id>/statistics   — patch-feature statistics
  GET  /api/features/<id>/pca-raw      — leading principal components
  GET  /api/image_proxy/<id>/<n>       — local image proxy (zero-egress)
  GET  /api/vision_umap, /api/language_umap — store-level projections
  GET  /api/ecosystems                 — ecosystem clustering
  GET  /api/ecosystem_map              — interactive HTML distribution map
  GET  /api/grid_statistics            — spatial grid aggregation
  GET  /static/<path>                  — static files
  POST /api/training/batch             — ML data service over HTTP
                                         (services/training_data.py:22-80)
  POST /api/projection                 — 2/3-D embedding projection
  POST /api/predict                    — model inference via the simple API
                                         (the predictor's ``predict``; each
                                         request on its own thread)

The server is a thin JSON layer over :class:`DataService`; heavy lifting
stays in the data layer so the same service powers tests without sockets.
"""

from __future__ import annotations

import json
import os as _os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.logging import get_logger
from ..utils.projection import EmbeddingProjector

logger = get_logger("Server")

# packaged single-page-app assets (index.html / app.js / style.css)
_UI_DIR = _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "static")
)


class DataService:
    """Backend for the REST routes: observations + embedding store + model."""

    def __init__(
        self,
        observations: Optional[Dict[str, np.ndarray]] = None,
        vision_loader=None,
        language_loader=None,
        predictor=None,
        config: Optional[Dict[str, Any]] = None,
        image_dir: Optional[str] = None,
        static_dir: Optional[str] = None,
        viewer_views=None,
    ):
        """observations: columns dict with at least gbif_id, lat, lon, species
        (ints); vision/language loaders: MMapEmbeddingLoader instances;
        predictor: DeepEarth API instance (optional); config: dataset config
        dict served at /api/config; image_dir: local directory backing the
        image proxy (``<gbif>_<n>.jpg`` — the reference proxied GBIF URLs,
        zero-egress here); static_dir: files served under /static/;
        viewer_views: the /visualizer scene, which needs
        ``reconstruction/interactive.py`` and is not ported yet (raises
        ``NotImplementedError``)."""
        if viewer_views is not None:
            raise NotImplementedError(
                "the /visualizer scene (reconstruction/interactive.py) is not "
                "ported yet: ROADMAP.md Queue 1, item 19")
        self.obs = observations or {}
        self.vision_loader = vision_loader
        self.language_loader = language_loader
        self.predictor = predictor
        self.config = config or {}
        self.image_dir = image_dir
        self.static_dir = static_dir
        self._start_time = time.time()
        self.request_count = 0
        # training-progress polling (reference:
        # dashboard/deepearth_dashboard.py:118-129 cache.current_progress)
        self._progress: Dict[str, Any] = {"status": "idle"}
        self._progress_lock = threading.Lock()

    def set_progress(self, **fields) -> None:
        """Called by trainers/loaders to publish progress for polling."""
        with self._progress_lock:
            self._progress.update(fields, updated_at=time.time())

    def progress(self) -> Dict[str, Any]:
        with self._progress_lock:
            return dict(self._progress)

    # -- route implementations ------------------------------------------------ #

    def health(self) -> Dict[str, Any]:
        return {
            "status": "healthy",
            "uptime_s": round(time.time() - self._start_time, 1),
            "n_observations": len(self.obs.get("gbif_id", [])),
            "vision_store": (
                {"n": len(self.vision_loader),
                 "mean_load_ms": self.vision_loader.mean_load_ms()}
                if self.vision_loader is not None else None
            ),
            "requests": self.request_count,
        }

    def observations(self, bbox=None, limit: int = 1000) -> Dict[str, Any]:
        n = len(self.obs.get("gbif_id", []))
        idx = np.arange(n)
        if bbox is not None and n:
            lat, lon = self.obs["lat"], self.obs["lon"]
            s, w, nn_, e = bbox
            idx = idx[(lat >= s) & (lat <= nn_) & (lon >= w) & (lon <= e)]
        idx = idx[:limit]
        years = self.obs.get("year")
        return {
            "count": int(len(idx)),
            "observations": [
                {
                    "gbif_id": int(self.obs["gbif_id"][i]),
                    "lat": float(self.obs["lat"][i]),
                    "lon": float(self.obs["lon"][i]),
                    "species": int(self.obs["species"][i]),
                    **({"year": int(years[i])} if years is not None else {}),
                }
                for i in idx
            ],
        }

    def observation(self, gbif_id: int) -> Optional[Dict[str, Any]]:
        ids = self.obs.get("gbif_id")
        if ids is None:
            return None
        hits = np.nonzero(np.asarray(ids) == gbif_id)[0]
        if not len(hits):
            return None
        i = int(hits[0])
        out = {k: _to_py(v[i]) for k, v in self.obs.items()}
        out["has_vision"] = (
            self.vision_loader is not None and gbif_id in self.vision_loader
        )
        return out

    def species(self) -> Dict[str, Any]:
        sp = np.asarray(self.obs.get("species", []))
        vals, counts = (
            np.unique(sp, return_counts=True) if len(sp) else ([], [])
        )
        return {
            "n_species": int(len(vals)),
            "counts": {int(v): int(c) for v, c in zip(vals, counts)},
        }

    def vision_embedding(self, gbif_id: int) -> Optional[Dict[str, Any]]:
        if self.vision_loader is None:
            return None
        emb = self.vision_loader.get(gbif_id)
        if emb is None:
            return None
        return {
            "gbif_id": gbif_id,
            "shape": list(emb.shape),
            "mean": float(emb.mean()),
            "std": float(emb.std()),
            "data": emb.reshape(-1)[:64].tolist(),  # preview slice
        }

    def training_batch(self, observation_ids) -> Dict[str, Any]:
        """ML data service (reference: dashboard/services/training_data.py:22-80)."""
        ids = [int(i) for i in observation_ids]
        n = len(ids)
        id_arr = np.asarray(self.obs.get("gbif_id", []))
        rows = []
        for oid in ids:
            hit = np.nonzero(id_arr == oid)[0]
            rows.append(int(hit[0]) if len(hit) else -1)
        rows = np.asarray(rows)
        ok = rows >= 0
        safe = np.where(ok, rows, 0)

        out: Dict[str, Any] = {
            "observation_ids": ids,
            "found": ok.tolist(),
            "species": np.where(
                ok, np.asarray(self.obs["species"])[safe], -1
            ).tolist(),
            "locations": np.stack(
                [
                    np.where(ok, np.asarray(self.obs["lat"])[safe], 0.0),
                    np.where(ok, np.asarray(self.obs["lon"])[safe], 0.0),
                    np.where(ok, np.asarray(self.obs.get("alt", np.zeros(len(id_arr))))[safe], 0.0),
                ],
                axis=-1,
            ).tolist(),
        }
        if "t_norm" in self.obs:
            out["timestamps"] = np.where(
                ok, np.asarray(self.obs["t_norm"])[safe], 0.0
            ).tolist()
        if self.vision_loader is not None:
            vis, found = self.vision_loader.get_batch(ids)
            out["vision_shape"] = list(vis.shape)
            out["vision_found"] = found.tolist()
        if self.language_loader is not None:
            lang, found = self.language_loader.get_batch(ids)
            out["language_shape"] = list(lang.shape)
            out["language_found"] = found.tolist()
        return out

    def projection(self, embeddings, n_components: int = 3) -> Dict[str, Any]:
        proj = EmbeddingProjector(n_components=n_components).fit_transform(
            np.asarray(embeddings, np.float32)
        )
        return {"projection": proj.tolist(), "n_components": n_components}

    def grid_statistics(self, n_bins: int = 10) -> Dict[str, Any]:
        """Spatial observation-count grid (reference: data_cache.py grid stats)."""
        if not len(self.obs.get("lat", [])):
            return {"grid": [], "n_bins": n_bins}
        lat, lon = np.asarray(self.obs["lat"]), np.asarray(self.obs["lon"])
        h, xe, ye = np.histogram2d(lat, lon, bins=n_bins)
        return {
            "grid": h.astype(int).tolist(),
            "lat_edges": xe.tolist(),
            "lon_edges": ye.tolist(),
            "n_bins": n_bins,
        }

    def predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if self.predictor is None:
            raise ValueError("no predictor configured")
        emb = self.predictor.predict(
            tuple(payload["location"]),
            payload.get("time"),
            payload.get("data", {}),
        )
        return {"embedding": np.asarray(emb).tolist()}

    def attention_map(self, gbif_id: int) -> Optional[Dict[str, Any]]:
        """Spatial saliency over the patch grid
        (reference: dashboard vision attention routes, data_cache.py)."""
        if self.vision_loader is None:
            return None
        emb = self.vision_loader.get(gbif_id)
        if emb is None:
            return None
        from ..data.observations import spatial_attention_map

        att = spatial_attention_map(np.asarray(emb))
        att = (att - att.min()) / (att.max() - att.min() + 1e-9)
        return {"gbif_id": gbif_id, "shape": list(att.shape),
                "attention": att.tolist()}

    def embedding_umap(
        self, which: str, max_items: int = 500, n_components: int = 3
    ) -> Dict[str, Any]:
        """Project stored embeddings to 2/3-D
        (reference: /api/language_umap, /api/vision_umap routes)."""
        loader = (
            self.vision_loader if which == "vision" else self.language_loader
        )
        if loader is None:
            raise ValueError(f"no {which} store configured")
        ids = loader.ids[:max_items]
        embs = []
        for oid in ids:
            e = loader.get(int(oid))
            embs.append(np.asarray(e).reshape(-1) if e.ndim > 1 else e)
        x = np.stack(embs)
        if x.shape[1] > 4096:  # pool giant vision embeddings channel-wise
            x = x.reshape(len(ids), -1, 1408).mean(1) if x.shape[1] % 1408 == 0 \
                else x[:, :4096]
        proj = EmbeddingProjector(n_components=n_components).fit_transform(x)
        return {
            "ids": [int(i) for i in ids],
            "projection": proj.tolist(),
            "n_components": n_components,
        }

    def _ecosystem_raw(self, n_clusters: int, max_items: int):
        if self.vision_loader is None or not len(self.obs.get("gbif_id", [])):
            raise ValueError("ecosystem analysis needs observations + vision store")
        from ..evaluation.ecosystems import analyze_ecosystems

        ids, embs, rows = [], [], []
        id_arr = np.asarray(self.obs["gbif_id"])
        for row, oid in enumerate(id_arr[:max_items]):
            e = self.vision_loader.get(int(oid))
            if e is None:
                continue
            e = np.asarray(e)
            embs.append(e.reshape(-1, e.shape[-1]).mean(0) if e.ndim > 1 else e)
            ids.append(int(oid))
            rows.append(row)
        rows = np.asarray(rows)
        out = analyze_ecosystems(
            np.stack(embs),
            np.asarray(self.obs["species"])[rows],
            np.asarray(self.obs["lat"])[rows],
            np.asarray(self.obs["lon"])[rows],
            n_clusters=min(n_clusters, max(2, len(ids) // 4)),
        )
        return ids, rows, out

    def ecosystems(self, n_clusters: int = 8, max_items: int = 1000) -> Dict[str, Any]:
        """Cluster observation embeddings into ecological communities
        (reference: /api/ecosystem_analysis route)."""
        ids, rows, out = self._ecosystem_raw(n_clusters, max_items)
        return {
            "silhouette": out["silhouette"],
            "labels": {i: int(l) for i, l in zip(ids, out["labels"])},
            "clusters": [
                {
                    "cluster_id": c.cluster_id,
                    "size": c.size,
                    "dominant_species": c.dominant_species,
                    "species_purity": c.species_purity,
                    "center": [c.center_lat, c.center_lon],
                    "radius_km": c.radius_km,
                }
                for c in out["clusters"]
            ],
        }

    def ecosystem_map(self, n_clusters: int = 8, max_items: int = 1000) -> str:
        """Interactive self-contained HTML distribution map
        (reference: training/florida_ecosystem_analysis.py folium map —
        here zero-egress canvas, see evaluation/ecosystems.py)."""
        from ..evaluation.ecosystems import ecosystem_map_html

        _, rows, out = self._ecosystem_raw(n_clusters, max_items)
        return ecosystem_map_html(
            np.asarray(self.obs["lat"])[rows],
            np.asarray(self.obs["lon"])[rows],
            out["labels"],
        )


    # -- visualization-surface routes (reference: deepearth_dashboard.py) --- #

    def species_umap_colors(self) -> Dict[str, Any]:
        """Stable RGB color per species for map display
        (reference: /api/species_umap_colors — UMAP of per-species language
        embeddings mapped to RGB; falls back to a deterministic hash palette
        when no language store is configured)."""
        sp = np.unique(np.asarray(self.obs.get("species", [])))
        colors: Dict[int, list] = {}
        if self.language_loader is not None and len(sp):
            id_arr = np.asarray(self.obs["gbif_id"])
            sp_arr = np.asarray(self.obs["species"])
            means = []
            kept = []
            for s in sp:
                ids = id_arr[sp_arr == s][:8]
                embs = [self.language_loader.get(int(i)) for i in ids]
                embs = [np.asarray(e).reshape(-1) for e in embs if e is not None]
                if embs:
                    means.append(np.stack(embs).mean(0))
                    kept.append(int(s))
            if len(means) >= 3:
                proj = EmbeddingProjector(n_components=3).fit_transform(
                    np.stack(means)
                )
                lo, hi = proj.min(0), proj.max(0)
                rgb = (proj - lo) / (hi - lo + 1e-9)
                for s, c in zip(kept, rgb):
                    colors[s] = [round(float(v), 4) for v in c]
        for s in sp:  # hash fallback for species without embeddings
            if int(s) not in colors:
                h = (int(s) * 2654435761) & 0xFFFFFF
                colors[int(s)] = [
                    ((h >> 16) & 255) / 255.0,
                    ((h >> 8) & 255) / 255.0,
                    (h & 255) / 255.0,
                ]
        return {"colors": {str(k): v for k, v in colors.items()}}

    def vision_available(self, limit: int = 10000) -> Dict[str, Any]:
        """IDs with stored vision embeddings
        (reference: /api/vision_embeddings/available)."""
        if self.vision_loader is None:
            return {"count": 0, "ids": []}
        ids = [int(i) for i in self.vision_loader.ids[:limit]]
        return {"count": len(self.vision_loader), "ids": ids}

    def species_observations(self, species: int, limit: int = 1000) -> Dict[str, Any]:
        """All observations of one species
        (reference: /api/species/<taxon_id>/observations)."""
        sp = np.asarray(self.obs.get("species", []))
        idx = np.nonzero(sp == species)[0][:limit]
        return {
            "species": species,
            "count": int(len(idx)),
            "observations": [
                {
                    "gbif_id": int(self.obs["gbif_id"][i]),
                    "lat": float(self.obs["lat"][i]),
                    "lon": float(self.obs["lon"][i]),
                }
                for i in idx
            ],
        }

    def _patch_features(self, gbif_id: int) -> Optional[np.ndarray]:
        """(24, 24, C) time-averaged patch features for one observation."""
        if self.vision_loader is None:
            return None
        emb = self.vision_loader.get(gbif_id)
        if emb is None:
            return None
        emb = np.asarray(emb)
        if emb.ndim == 4:  # (T, H, W, C) → time-mean
            return emb.mean(0)
        if emb.ndim == 2:  # (S, C) square grid
            side = int(np.sqrt(emb.shape[0]))
            return emb[: side * side].reshape(side, side, -1)
        return None

    def features_umap_rgb(self, gbif_id: int) -> Optional[Dict[str, Any]]:
        """Per-patch 3-D projection → RGB grid
        (reference: /api/features/<id>/umap-rgb)."""
        feats = self._patch_features(gbif_id)
        if feats is None:
            return None
        h, w, c = feats.shape
        proj = EmbeddingProjector(n_components=3).fit_transform(
            feats.reshape(-1, c)
        )
        lo, hi = proj.min(0), proj.max(0)
        rgb = ((proj - lo) / (hi - lo + 1e-9)).reshape(h, w, 3)
        return {"gbif_id": gbif_id, "shape": [h, w, 3],
                "rgb": np.round(rgb, 4).tolist()}

    def features_statistics(self, gbif_id: int) -> Optional[Dict[str, Any]]:
        """Patch-feature statistics (reference: /api/features/<id>/statistics)."""
        feats = self._patch_features(gbif_id)
        if feats is None:
            return None
        norms = np.linalg.norm(feats, axis=-1)
        return {
            "gbif_id": gbif_id,
            "grid": list(feats.shape[:2]),
            "channels": int(feats.shape[-1]),
            "feature_mean": float(feats.mean()),
            "feature_std": float(feats.std()),
            "patch_norm_mean": float(norms.mean()),
            "patch_norm_std": float(norms.std()),
            "patch_norm_min": float(norms.min()),
            "patch_norm_max": float(norms.max()),
        }

    def features_pca_raw(self, gbif_id: int, k: int = 3) -> Optional[Dict[str, Any]]:
        """Raw leading principal components per patch
        (reference: /api/features/<id>/pca-raw)."""
        feats = self._patch_features(gbif_id)
        if feats is None:
            return None
        h, w, c = feats.shape
        comp = EmbeddingProjector(
            n_components=k, method="pca"
        ).fit_transform(feats.reshape(-1, c)).reshape(h, w, k)
        return {"gbif_id": gbif_id, "shape": [h, w, k],
                "components": np.round(comp, 5).tolist()}

    def image_path(self, gbif_id: int, image_num: int) -> Optional[str]:
        """Local file behind the image proxy (reference:
        /api/image_proxy/<gbif>/<n> fetched GBIF media URLs; this image has
        zero egress, so the proxy serves a configured local directory)."""
        if self.image_dir is None:
            return None
        for ext in ("jpg", "jpeg", "png"):
            p = _os.path.join(self.image_dir, f"{gbif_id}_{image_num}.{ext}")
            if _os.path.exists(p):
                return p
        return None


_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>DeepEarth-TPU dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:70rem}
 h1{font-size:1.3rem} table{border-collapse:collapse;font-size:.85rem}
 td,th{border:1px solid #ccc;padding:.2rem .5rem} #grid{margin-top:1rem}
 .cell{display:inline-block;width:14px;height:14px;margin:1px}
</style></head><body>
<h1>DeepEarth-TPU dashboard</h1>
<div id="health">loading…</div>
<div id="progress"></div>
<h2>Observation density</h2><div id="grid"></div>
<h2>Observations</h2><table id="obs"><tr>
<th>gbif_id</th><th>lat</th><th>lon</th><th>species</th></tr></table>
<script>
async function j(u){const r=await fetch(u);return r.json()}
(async()=>{
 const h=await j('/api/health');
 document.getElementById('health').textContent=
   `status: ${h.status} · ${h.n_observations} observations · `+
   `${h.requests} requests · up ${h.uptime_s}s`;
 const p=await j('/api/progress');
 document.getElementById('progress').textContent='training: '+
   JSON.stringify(p);
 const g=await j('/api/grid_statistics?n_bins=16');
 const mx=Math.max(1,...g.grid.flat());
 document.getElementById('grid').innerHTML=g.grid.map(row=>
   row.map(v=>`<span class="cell" style="background:rgba(16,90,160,${v/mx})"></span>`)
      .join('')).join('<br>');
 const o=await j('/api/observations?limit=25');
 const t=document.getElementById('obs');
 for(const r of o.observations){const tr=document.createElement('tr');
  tr.innerHTML=`<td>${r.gbif_id}</td><td>${r.lat.toFixed(4)}</td>`+
    `<td>${r.lon.toFixed(4)}</td><td>${r.species}</td>`;t.appendChild(tr);}
})();
</script></body></html>"""


def _to_py(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def make_handler(service: DataService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to our logger
            logger.debug(fmt % args)

        def _send(self, code: int, payload: Any) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_raw(self, body: bytes, ctype: str) -> None:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_file(self, path: str) -> None:
            import mimetypes

            ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
            with open(path, "rb") as f:
                self._send_raw(f.read(), ctype)

        def do_GET(self):
            service.request_count += 1
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            q = parse_qs(url.query)
            try:
                if not parts:
                    # '/' — the interactive single-page app (reference:
                    # dashboard/templates/dashboard.html + static/js/
                    # dashboard.js); falls back to the minimal status page
                    # if packaged assets are missing
                    idx = _os.path.join(_UI_DIR, "index.html")
                    if _os.path.exists(idx):
                        return self._send_file(idx)
                    return self._send_raw(
                        _INDEX_HTML.encode(), "text/html; charset=utf-8"
                    )
                if parts[0] == "ui" and len(parts) >= 2:
                    # packaged frontend assets (kept separate from the
                    # user-configurable /static/ dir)
                    p = _os.path.abspath(_os.path.join(_UI_DIR, *parts[1:]))
                    if p.startswith(_UI_DIR + _os.sep) and _os.path.exists(p):
                        return self._send_file(p)
                    return self._send(404, {"error": "not found"})
                if parts == ["visualizer"]:
                    return self._send(
                        404, {"error": "no viewer scene configured"}
                    )
                if parts == ["api", "config"]:
                    return self._send(200, service.config)
                if parts == ["api", "progress"]:
                    return self._send(200, service.progress())
                if parts == ["api", "species_umap_colors"]:
                    return self._send(200, service.species_umap_colors())
                if parts == ["api", "vision_embeddings", "available"]:
                    return self._send(200, service.vision_available())
                if (
                    len(parts) == 4
                    and parts[:2] == ["api", "species"]
                    and parts[3] == "observations"
                ):
                    return self._send(
                        200,
                        service.species_observations(
                            int(parts[2]),
                            limit=int(q.get("limit", ["1000"])[0]),
                        ),
                    )
                if len(parts) == 4 and parts[:2] == ["api", "features"]:
                    gid = int(parts[2])
                    fn = {
                        "umap-rgb": service.features_umap_rgb,
                        "statistics": service.features_statistics,
                        "pca-raw": service.features_pca_raw,
                        "attention": service.attention_map,
                    }.get(parts[3])
                    if fn is None:
                        return self._send(404, {"error": "unknown feature op"})
                    out = fn(gid)
                    if out is None:
                        return self._send(404, {"error": "not found"})
                    return self._send(200, out)
                if len(parts) == 4 and parts[:2] == ["api", "image_proxy"]:
                    p = service.image_path(int(parts[2]), int(parts[3]))
                    if p is None:
                        return self._send(
                            404,
                            {"error": "no local image; zero-egress build "
                             "serves image_dir only"},
                        )
                    return self._send_file(p)
                if len(parts) >= 2 and parts[0] == "static":
                    if service.static_dir is None:
                        return self._send(404, {"error": "no static dir"})
                    root = _os.path.abspath(service.static_dir)
                    p = _os.path.abspath(_os.path.join(root, *parts[1:]))
                    if not p.startswith(root + _os.sep) or not _os.path.exists(p):
                        return self._send(404, {"error": "not found"})
                    return self._send_file(p)
                if parts == ["api", "health"]:
                    return self._send(200, service.health())
                if parts == ["api", "observations"]:
                    bbox = None
                    if "bbox" in q:  # bbox=s,w,n,e
                        bbox = [float(x) for x in q["bbox"][0].split(",")]
                    limit = int(q.get("limit", ["1000"])[0])
                    return self._send(200, service.observations(bbox, limit))
                if len(parts) == 3 and parts[:2] == ["api", "observation"]:
                    obs = service.observation(int(parts[2]))
                    if obs is None:
                        return self._send(404, {"error": "not found"})
                    return self._send(200, obs)
                if parts == ["api", "species"]:
                    return self._send(200, service.species())
                if len(parts) == 3 and parts[:2] == ["api", "vision_embedding"]:
                    emb = service.vision_embedding(int(parts[2]))
                    if emb is None:
                        return self._send(404, {"error": "not found"})
                    return self._send(200, emb)
                if parts == ["api", "grid_statistics"]:
                    n_bins = int(q.get("n_bins", ["10"])[0])
                    return self._send(200, service.grid_statistics(n_bins))
                if len(parts) == 3 and parts[:2] == ["api", "attention_map"]:
                    att = service.attention_map(int(parts[2]))
                    if att is None:
                        return self._send(404, {"error": "not found"})
                    return self._send(200, att)
                if parts in (["api", "vision_umap"], ["api", "language_umap"]):
                    which = parts[1].split("_")[0]
                    return self._send(
                        200,
                        service.embedding_umap(
                            which,
                            max_items=int(q.get("max_items", ["500"])[0]),
                            n_components=int(q.get("n_components", ["3"])[0]),
                        ),
                    )
                if parts == ["api", "ecosystems"]:
                    return self._send(
                        200,
                        service.ecosystems(
                            n_clusters=int(q.get("n_clusters", ["8"])[0])
                        ),
                    )
                if parts == ["api", "ecosystem_map"]:
                    return self._send_raw(
                        service.ecosystem_map(
                            n_clusters=int(q.get("n_clusters", ["8"])[0])
                        ).encode(),
                        "text/html; charset=utf-8",
                    )
                return self._send(404, {"error": f"unknown route {url.path}"})
            except Exception as e:  # route errors → 500 JSON, not a stack dump
                return self._send(500, {"error": str(e)})

        def do_POST(self):
            service.request_count += 1
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if parts == ["api", "training", "batch"]:
                    return self._send(
                        200, service.training_batch(payload["observation_ids"])
                    )
                if parts == ["api", "projection"]:
                    return self._send(
                        200,
                        service.projection(
                            payload["embeddings"],
                            payload.get("n_components", 3),
                        ),
                    )
                if parts == ["api", "predict"]:
                    return self._send(200, service.predict(payload))
                return self._send(404, {"error": f"unknown route {url.path}"})
            except KeyError as e:
                return self._send(400, {"error": f"missing field {e}"})
            except Exception as e:
                return self._send(500, {"error": str(e)})

    return Handler


class DashboardServer:
    """Threaded HTTP server wrapper with start/stop."""

    def __init__(self, service: DataService, host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), make_handler(service))
        self.host, self.port = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DashboardServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info(f"dashboard serving on http://{self.host}:{self.port}")
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
