"""Embedding projection for visualization (UMAP-equivalent): the port's
copy of ``deepearth_tpu/utils/projection.py``.

The reference projects embeddings with disk-cached UMAP reducers
(reference: dashboard/umap_optimized.py:24-132, encoders/language/
umap_processor.py). umap-learn isn't in this image, so 'umap' resolves to
the self-contained implementation in utils/umap_native.py (same algorithm,
no numba); if umap-learn appears on the path it is used transparently.
PCA and t-SNE remain available as explicit methods, with the same
disk-cache behaviour for all three.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional

import numpy as np


class EmbeddingProjector:
    """Project (N, D) embeddings to 2/3-D with a disk-cached reducer."""

    def __init__(
        self,
        n_components: int = 3,
        method: str = "auto",  # 'auto' | 'pca' | 'tsne' | 'umap'
        cache_dir: Optional[str] = None,
        random_state: int = 42,
    ):
        self.n_components = n_components
        self.method = method
        self.cache_dir = cache_dir
        self.random_state = random_state
        self._reducer = None

    def _resolve_method(self) -> str:
        if self.method != "auto":
            return self.method
        # 'umap' always resolves: umap-learn when installed, else the
        # native implementation (utils/umap_native.py).
        return "umap"

    def _cache_path(self, x: np.ndarray, method: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        h = hashlib.sha1(
            x.tobytes() + f"{method}{self.n_components}".encode()
        ).hexdigest()[:16]
        os.makedirs(self.cache_dir, exist_ok=True)
        return os.path.join(self.cache_dir, f"proj_{h}.pkl")

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        method = self._resolve_method()
        cache = self._cache_path(x, method)
        if cache and os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)

        if method == "umap":
            try:
                import umap
            except ImportError:
                from . import umap_native as umap

            out = umap.UMAP(
                n_components=self.n_components,
                random_state=self.random_state,
                n_neighbors=min(15, max(2, len(x) - 1)),
            ).fit_transform(x)
        elif method == "tsne":
            from sklearn.manifold import TSNE

            out = TSNE(
                n_components=self.n_components,
                random_state=self.random_state,
                init="pca",
                perplexity=min(30, max(5, len(x) // 4)),
            ).fit_transform(x)
        else:  # pca
            from sklearn.decomposition import PCA

            p = PCA(n_components=self.n_components, random_state=self.random_state)
            out = p.fit_transform(x)
            self._reducer = p

        out = np.asarray(out, np.float32)
        if cache:
            with open(cache, "wb") as f:
                pickle.dump(out, f)
        return out

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Project new points (PCA only; other reducers re-fit)."""
        if self._reducer is not None:
            return np.asarray(self._reducer.transform(np.asarray(x, np.float32)),
                              np.float32)
        return self.fit_transform(x)
