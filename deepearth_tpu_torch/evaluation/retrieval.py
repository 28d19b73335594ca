"""Cross-modal k-NN retrieval evaluation (the port's copy of
``deepearth_tpu/evaluation/retrieval.py``)
(reference: training/multimodal_autoencoder.py k-NN retrieval eval).

Given paired embeddings from two modalities (or query/gallery sets), compute
recall@k and median rank under cosine similarity — the standard measure of
cross-modal alignment quality.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-8)


def retrieval_metrics(
    queries: np.ndarray,
    gallery: np.ndarray,
    ks: Sequence[int] = (1, 5, 10),
    positive_labels: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """recall@k + median rank for query→gallery retrieval.

    By default query i's positive is gallery item i (paired data). With
    ``positive_labels`` (labels for both sets, same length), any gallery item
    sharing the query's label counts as a hit — the species-aware variant
    matching the reference's contrastive objective.
    """
    q = _normalize(queries)
    g = _normalize(gallery)
    sim = q @ g.T  # (Nq, Ng)
    order = np.argsort(-sim, axis=1)  # descending similarity

    n = len(q)
    if positive_labels is None:
        # rank of the paired item
        ranks = np.empty(n, dtype=np.int64)
        for i in range(n):
            ranks[i] = int(np.nonzero(order[i] == i)[0][0])
    else:
        labels = np.asarray(positive_labels)
        ranks = np.empty(n, dtype=np.int64)
        for i in range(n):
            hits = labels[order[i]] == labels[i]
            ranks[i] = int(np.argmax(hits))  # first same-label item

    out: Dict[str, float] = {
        "median_rank": float(np.median(ranks) + 1),
        "mean_rank": float(ranks.mean() + 1),
    }
    for k in ks:
        out[f"recall@{k}"] = float((ranks < k).mean())
    return out


def cross_modal_retrieval(
    emb_a: np.ndarray,
    emb_b: np.ndarray,
    ks: Sequence[int] = (1, 5, 10),
    labels: Optional[np.ndarray] = None,
) -> Dict[str, Dict[str, float]]:
    """Both retrieval directions (a→b and b→a) for paired embeddings."""
    return {
        "a_to_b": retrieval_metrics(emb_a, emb_b, ks, labels),
        "b_to_a": retrieval_metrics(emb_b, emb_a, ks, labels),
    }
