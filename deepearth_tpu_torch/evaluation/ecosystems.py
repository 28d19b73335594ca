"""Ecosystem analysis: cluster learned embeddings into ecological communities
(the port's copy of ``deepearth_tpu/evaluation/ecosystems.py``; scikit-learn
is imported only when a clustering runs)
(reference: evaluation/florida_ecosystem_analysis.py and
dashboard/services/ecosystem_processing.py).

Clusters fused observation embeddings (KMeans), characterizes each cluster by
its dominant species and spatial footprint, and scores cluster quality.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class EcosystemCluster:
    cluster_id: int
    size: int
    centroid: np.ndarray
    dominant_species: List[int]  # top species indices by frequency
    species_purity: float  # fraction in the single most common species
    center_lat: float
    center_lon: float
    radius_km: float


def analyze_ecosystems(
    embeddings: np.ndarray,
    species: np.ndarray,
    lat: np.ndarray,
    lon: np.ndarray,
    n_clusters: int = 8,
    random_state: int = 42,
) -> Dict[str, object]:
    """Cluster embeddings and describe the resulting ecosystems.

    Returns dict with 'clusters' (list of EcosystemCluster), 'labels' (N,),
    and 'silhouette' quality score.
    """
    from sklearn.cluster import KMeans
    from sklearn.metrics import silhouette_score

    x = np.asarray(embeddings, np.float32)
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    km = KMeans(n_clusters=n_clusters, random_state=random_state, n_init=4)
    labels = km.fit_predict(x)

    sil = float(silhouette_score(x, labels)) if n_clusters > 1 else 0.0

    from .spatiotemporal import haversine_like

    clusters = []
    for c in range(n_clusters):
        m = labels == c
        if not m.any():
            continue
        sp, counts = np.unique(species[m], return_counts=True)
        order = np.argsort(counts)[::-1]
        clat, clon = float(lat[m].mean()), float(lon[m].mean())
        d = haversine_like(lat[m], lon[m], clat, clon)
        clusters.append(
            EcosystemCluster(
                cluster_id=c,
                size=int(m.sum()),
                centroid=km.cluster_centers_[c],
                dominant_species=[int(s) for s in sp[order][:5]],
                species_purity=float(counts.max() / counts.sum()),
                center_lat=clat,
                center_lon=clon,
                radius_km=float(np.percentile(d, 90)),
            )
        )
    return {"clusters": clusters, "labels": labels, "silhouette": sil}


def species_similarity(
    embeddings: np.ndarray, species: np.ndarray, top_k: int = 10
) -> Dict[str, object]:
    """Per-species mean-embedding cosine similarity + most-similar pairs
    (reference: training/florida_ecosystem_analysis.py:204-262).

    Returns dict with 'species_ids' (S,), 'similarity' (S, S), and 'pairs'
    — the top_k most similar distinct pairs as (id_a, id_b, cosine).
    """
    x = np.asarray(embeddings, np.float32)
    sp = np.asarray(species)
    ids = np.unique(sp)
    means = np.stack([x[sp == s].mean(axis=0) for s in ids])
    n = means / (np.linalg.norm(means, axis=1, keepdims=True) + 1e-8)
    sim = n @ n.T
    iu = np.triu_indices(len(ids), k=1)
    order = np.argsort(sim[iu])[::-1][:top_k]
    pairs = [
        (int(ids[iu[0][o]]), int(ids[iu[1][o]]), float(sim[iu][o]))
        for o in order
    ]
    return {"species_ids": ids, "similarity": sim, "pairs": pairs}


_MAP_PALETTE = [
    "#4c78a8", "#f58518", "#54a24b", "#e45756", "#72b7b2",
    "#eeca3b", "#b279a2", "#ff9da6", "#9d755d", "#bab0ac",
]


def ecosystem_map_html(
    lat: np.ndarray,
    lon: np.ndarray,
    labels: np.ndarray,
    path: "str | None" = None,
    title: str = "Ecosystem distribution",
) -> str:
    """Interactive geographic distribution map as a SELF-CONTAINED html
    file (reference: training/florida_ecosystem_analysis.py:159-201 —
    which used folium/leaflet and therefore a CDN; this canvas version is
    zero-egress like the rest of the serving stack). Pan with drag, zoom
    with the wheel; a legend lists cluster sizes.
    """
    import html as _html
    import json as _json

    title = _html.escape(title)  # injection-safe interpolation (ADVICE r2)
    lat = np.asarray(lat, float)
    lon = np.asarray(lon, float)
    labels = np.asarray(labels, int)
    pts = [
        [round(float(lo), 5), round(float(la), 5), int(c)]
        for la, lo, c in zip(lat, lon, labels)
    ]
    sizes = {int(c): int((labels == c).sum()) for c in np.unique(labels)}
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{title}</title><style>
body{{margin:0;font-family:sans-serif;background:#111;color:#eee}}
#legend{{position:fixed;top:10px;right:10px;background:#222a;padding:8px 12px;
border-radius:6px;font-size:13px}}
canvas{{display:block}}</style></head><body>
<div id="legend"><b>{title}</b></div><canvas id="c"></canvas><script>
const PTS={_json.dumps(pts)};const SIZES={_json.dumps(sizes)};
const COLORS={_json.dumps(_MAP_PALETTE)};
const cv=document.getElementById("c"),ctx=cv.getContext("2d");
let W,H,sc,ox,oy,drag=null;
const lons=PTS.map(p=>p[0]),lats=PTS.map(p=>p[1]);
const mnx=Math.min(...lons),mxx=Math.max(...lons),
      mny=Math.min(...lats),mxy=Math.max(...lats);
function fit(){{W=cv.width=innerWidth;H=cv.height=innerHeight;
sc=0.9*Math.min(W/(mxx-mnx+1e-9),H/(mxy-mny+1e-9));
ox=W/2-sc*(mnx+mxx)/2;oy=H/2+sc*(mny+mxy)/2;draw();}}
function draw(){{ctx.fillStyle="#111";ctx.fillRect(0,0,W,H);
for(const[lo,la,c]of PTS){{ctx.fillStyle=COLORS[c%COLORS.length];
ctx.beginPath();ctx.arc(ox+sc*lo,oy-sc*la,3,0,6.3);ctx.fill();}}}}
cv.onwheel=e=>{{e.preventDefault();const f=e.deltaY<0?1.15:0.87;
ox=e.clientX-(e.clientX-ox)*f;oy=e.clientY-(e.clientY-oy)*f;sc*=f;draw();}};
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
cv.onmousemove=e=>{{if(drag){{ox+=e.clientX-drag[0];oy+=e.clientY-drag[1];
drag=[e.clientX,e.clientY];draw();}}}};
cv.onmouseup=()=>drag=null;addEventListener("resize",fit);
const lg=document.getElementById("legend");
for(const[c,n]of Object.entries(SIZES)){{const d=document.createElement("div");
d.innerHTML=`<span style="color:${{COLORS[c%COLORS.length]}}">●</span> `+
`cluster ${{c}}: ${{n}} obs`;lg.appendChild(d);}}
fit();</script></body></html>"""
    if path is not None:
        with open(path, "w") as f:
            f.write(html)
        return path
    return html
