"""Self-contained UMAP (no umap-learn / numba dependency): the port's copy
of ``deepearth_tpu/utils/umap_native.py``.

The reference projects embeddings with umap-learn behind a warm-up +
disk-cache wrapper (reference: dashboard/umap_optimized.py:24-132,
encoders/language/umap_processor.py). umap-learn is not in this image, so
this module implements the UMAP algorithm itself — kNN graph → smoothed
fuzzy simplicial set → (a, b) curve fit → spectral init → negative-sampling
SGD layout — in vectorized numpy, faithful to the published algorithm
(McInnes et al. 2018) and to umap-learn's defaults (n_neighbors=15,
min_dist=0.1, spread=1.0, negative_sample_rate=5, clip gradients to ±4,
linearly annealed learning rate).

Differences from umap-learn, on purpose:
- The layout SGD is batched per epoch (all currently-due edges updated
  with `np.add.at`) instead of numba's sequential/hogwild loop. umap-learn
  itself runs hogwild-parallel with racing writes, so batched accumulation
  is within the algorithm's own tolerance; edge-sampling frequencies
  (epochs_per_sample bookkeeping) match umap-learn exactly.
- Exactly `negative_sample_rate` negatives are drawn per attracted edge
  (umap-learn draws a variable number with the same expectation).

Deterministic for a fixed random_state. Used by utils/projection.py as the
default projector and by the dashboard UMAP routes.
"""

from __future__ import annotations

import numpy as np

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


# Above this many points, _knn switches from exact brute force (O(N²D)) to
# NN-descent (round-3 verdict item 7: 33k × 7168-d took minutes exact;
# umap-learn itself uses NN-descent — reference: dashboard/umap_optimized.py
# runs pynndescent through umap.UMAP).
NN_DESCENT_THRESHOLD = 8192


def _knn_exact(x: np.ndarray, n_neighbors: int, metric: str):
    """Exact kNN (self excluded) via sklearn; returns (indices, distances)."""
    from sklearn.neighbors import NearestNeighbors

    nn = NearestNeighbors(n_neighbors=n_neighbors + 1, metric=metric)
    nn.fit(x)
    dist, idx = nn.kneighbors(x)
    return idx[:, 1:], dist[:, 1:].astype(np.float64)


def _reverse_sample(idx: np.ndarray, k: int, rng: np.random.Generator):
    """Up to k reverse neighbors per point (who lists me?), random fill."""
    n, kk = idx.shape
    src = np.repeat(np.arange(n), kk)
    dst = idx.ravel()
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    starts = np.searchsorted(dst_s, np.arange(n))
    counts = np.searchsorted(dst_s, np.arange(n) + 1) - starts
    take = np.minimum(counts, k)
    pos = starts[:, None] + np.arange(k)[None, :]
    valid = np.arange(k)[None, :] < take[:, None]
    vals = src_s[np.where(valid, pos, 0)]
    return np.where(valid, vals, rng.integers(0, n, (n, k)))


def _knn_nn_descent(
    x: np.ndarray,
    n_neighbors: int,
    metric: str,
    rng: np.random.Generator,
    n_iters: int = 12,
    min_update_frac: float = 0.001,
):
    """Approximate kNN by NN-descent (Dong et al. 2011), vectorized numpy.

    Per iteration each point's candidate pool is its current neighbors,
    their neighbors (the NN-descent local join), sampled REVERSE neighbors,
    and a few random probes; the pool is distance-ranked and the k best
    unique ids kept. Converges when fewer than ``min_update_frac`` of
    neighbor slots change. Recall ≥0.9 vs exact kNN is pinned by
    tests/test_umap_native.py on 5k points.

    cosine is served by running on L2-normalized rows (d_cos = ‖u−v‖²/2 on
    the unit sphere, order-preserving and exact).
    """
    n, d = x.shape
    k = n_neighbors
    xw = np.ascontiguousarray(x, np.float32)
    if metric == "cosine":
        xw = xw / np.maximum(
            np.linalg.norm(xw, axis=1, keepdims=True), 1e-12
        )
    elif metric != "euclidean":
        raise ValueError(f"nn-descent supports euclidean/cosine, got {metric}")
    sq = (xw * xw).sum(axis=1)

    idx = rng.integers(0, n, (n, k))
    n_rand = max(k // 2, 1)
    # chunk so the gathered (chunk, m, d) candidate block stays ~256 MB
    m_guess = k * k + 2 * k + n_rand

    for it in range(n_iters):
        non = idx[idx.ravel()].reshape(n, k * k)
        rev = _reverse_sample(idx, k, rng)
        rand = rng.integers(0, n, (n, n_rand))
        cand = np.concatenate([idx, non, rev, rand], axis=1)
        m = cand.shape[1]
        chunk = max(16, int(2 ** 26 / max(m * d, 1)))
        new_idx = np.empty((n, k), np.int64)
        new_dsq = np.empty((n, k), np.float64)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            c = cand[s:e]
            rows = np.arange(s, e)
            dots = np.einsum(
                "cd,cmd->cm", xw[rows], xw[c], optimize=True
            )
            dsq = np.maximum(
                sq[rows][:, None] + sq[c] - 2.0 * dots, 0.0
            ).astype(np.float64)
            dsq[c == rows[:, None]] = np.inf  # exclude self
            # unique-per-row: id-sort, kill repeats, then distance-rank
            id_order = np.argsort(c, axis=1, kind="stable")
            c_s = np.take_along_axis(c, id_order, 1)
            d_s = np.take_along_axis(dsq, id_order, 1)
            dup = np.zeros_like(c_s, bool)
            dup[:, 1:] = c_s[:, 1:] == c_s[:, :-1]
            d_s[dup] = np.inf
            sel = np.argpartition(d_s, k - 1, axis=1)[:, :k]
            dk = np.take_along_axis(d_s, sel, 1)
            ck = np.take_along_axis(c_s, sel, 1)
            o = np.argsort(dk, axis=1)
            new_idx[s:e] = np.take_along_axis(ck, o, 1)
            new_dsq[s:e] = np.take_along_axis(dk, o, 1)
        changed = int((np.sort(new_idx, 1) != np.sort(idx, 1)).sum())
        idx = new_idx
        if it > 0 and changed < min_update_frac * n * k:
            break

    if metric == "cosine":
        dist = new_dsq / 2.0
    else:
        dist = np.sqrt(new_dsq)
    return idx, dist


def _knn(x: np.ndarray, n_neighbors: int, metric: str,
         method: str = "auto", random_state: int = 42):
    """kNN graph (self excluded): exact brute force for small N, NN-descent
    above NN_DESCENT_THRESHOLD (method='exact'/'nnd' forces a path)."""
    n = x.shape[0]
    use_nnd = method == "nnd" or (
        method == "auto"
        and n > NN_DESCENT_THRESHOLD
        and metric in ("euclidean", "cosine")
    )
    if use_nnd:
        return _knn_nn_descent(
            np.asarray(x, np.float32), n_neighbors, metric,
            np.random.default_rng(random_state),
        )
    return _knn_exact(x, n_neighbors, metric)


def smooth_knn_dist(distances: np.ndarray, k: float, n_iter: int = 64):
    """Per-point (rho, sigma): binary-search sigma so that
    sum_j exp(-max(0, d_ij - rho_i) / sigma_i) = log2(k).

    Vectorized equivalent of umap-learn's smooth_knn_dist.
    """
    n = distances.shape[0]
    target = np.log2(k)
    rho = np.zeros(n)
    nonzero = distances > 0.0
    has_nz = nonzero.any(axis=1)
    # rho = distance to the nearest *distinct* neighbor
    masked = np.where(nonzero, distances, np.inf)
    rho[has_nz] = masked[has_nz].min(axis=1)

    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    mid = np.ones(n)
    for _ in range(n_iter):
        d = np.maximum(distances - rho[:, None], 0.0)
        psum = np.exp(-d / mid[:, None]).sum(axis=1)
        err = psum - target
        done = np.abs(err) < SMOOTH_K_TOLERANCE
        if done.all():
            break
        too_big = err > 0
        hi = np.where(too_big, mid, hi)
        lo = np.where(too_big, lo, mid)
        mid = np.where(
            too_big,
            (lo + hi) / 2.0,
            np.where(np.isinf(hi), mid * 2.0, (lo + hi) / 2.0),
        )
        mid = np.where(done, mid, np.maximum(mid, 1e-12))
    # floor sigma at a fraction of the mean distance (umap-learn semantics)
    mean_d = distances.mean()
    mean_row = np.where(
        distances.sum(axis=1) > 0, distances.mean(axis=1), mean_d
    )
    floor = np.where(rho > 0.0, MIN_K_DIST_SCALE * mean_row,
                     MIN_K_DIST_SCALE * mean_d)
    return rho, np.maximum(mid, floor)


def fuzzy_simplicial_set(knn_idx, knn_dist, n_points: int):
    """Directed membership strengths → probabilistic t-conorm symmetrization.

    Returns a scipy.sparse CSR matrix W = A + A^T - A∘A^T.
    """
    import scipy.sparse as sp

    n, k = knn_idx.shape
    rho, sigma = smooth_knn_dist(knn_dist, float(k))
    w = np.exp(-np.maximum(knn_dist - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), k)
    cols = knn_idx.ravel()
    a = sp.coo_matrix((w.ravel(), (rows, cols)), shape=(n_points, n_points))
    a = a.tocsr()
    at = a.T.tocsr()
    prod = a.multiply(at)
    return (a + at - prod).tocoo()


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1):
    """Fit the differentiable curve 1/(1 + a x^{2b}) to the target
    exp(-(x - min_dist)/spread) (1 for x <= min_dist)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(curve, xv, yv)
    return float(a), float(b)


def spectral_init(graph, n_components: int, rng: np.random.Generator):
    """Embed with the first nontrivial eigenvectors of the symmetric
    normalized Laplacian; fall back to scaled-random on failure."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = graph.shape[0]
    g = graph.tocsr()
    deg = np.asarray(g.sum(axis=1)).ravel()
    deg = np.where(deg > 0, deg, 1.0)
    dinv = sp.diags(1.0 / np.sqrt(deg))
    lap = sp.identity(n) - dinv @ g @ dinv
    k = n_components + 1
    try:
        if n <= 2048:
            # dense solve: faster and more robust than ARPACK at this size
            from scipy.linalg import eigh

            vals, vecs = eigh(
                lap.toarray().astype(np.float64),
                subset_by_index=[0, k - 1],
            )
        else:
            # shift-invert around 0 converges far faster than which='SM'
            vals, vecs = spla.eigsh(
                lap.astype(np.float64), k=k, sigma=0.0, which="LM",
                maxiter=n * 20, v0=rng.standard_normal(n),
            )
        order = np.argsort(vals)
        emb = vecs[:, order[1 : n_components + 1]]
        # scale to ±10 like umap-learn, jitter to break exact ties
        span = np.abs(emb).max()
        emb = emb / (span if span > 0 else 1.0) * 10.0
        emb = emb + rng.normal(0, 1e-4, emb.shape)
        return emb.astype(np.float32)
    except Exception:
        return (rng.uniform(-10, 10, (n, n_components))).astype(np.float32)


def make_epochs_per_sample(weights: np.ndarray, n_epochs: int) -> np.ndarray:
    result = np.full(weights.shape[0], -1.0)
    n_samples = n_epochs * (weights / weights.max())
    result[n_samples > 0] = n_epochs / n_samples[n_samples > 0]
    return result


def optimize_layout(
    emb: np.ndarray,
    head: np.ndarray,
    tail: np.ndarray,
    epochs_per_sample: np.ndarray,
    a: float,
    b: float,
    n_epochs: int,
    rng: np.random.Generator,
    negative_sample_rate: int = 5,
    initial_alpha: float = 1.0,
) -> np.ndarray:
    """Batched negative-sampling SGD (see module docstring for the
    relationship to umap-learn's sequential numba loop)."""
    n = emb.shape[0]
    emb = emb.astype(np.float32).copy()
    next_sample = epochs_per_sample.copy()
    for epoch in range(n_epochs):
        alpha = initial_alpha * (1.0 - epoch / float(n_epochs))
        due = next_sample <= epoch
        if not due.any():
            continue
        next_sample[due] += epochs_per_sample[due]
        hi = head[due]
        ti = tail[due]
        # --- attractive updates (move both endpoints) ---
        diff = emb[hi] - emb[ti]
        dsq = (diff * diff).sum(axis=1)
        pos = dsq > 0.0
        coeff = np.zeros_like(dsq)
        coeff[pos] = (-2.0 * a * b * dsq[pos] ** (b - 1.0)) / (
            a * dsq[pos] ** b + 1.0
        )
        grad = np.clip(coeff[:, None] * diff, -4.0, 4.0) * alpha
        np.add.at(emb, hi, grad)
        np.add.at(emb, ti, -grad)
        # --- repulsive updates (negatives; move head only) ---
        for _ in range(negative_sample_rate):
            ni = rng.integers(0, n, hi.shape[0])
            diff = emb[hi] - emb[ni]
            dsq = (diff * diff).sum(axis=1)
            coeff = (2.0 * b) / ((0.001 + dsq) * (a * dsq**b + 1.0))
            grad = np.clip(coeff[:, None] * diff, -4.0, 4.0)
            grad[hi == ni] = 0.0  # self-pairs contribute nothing
            np.add.at(emb, hi, grad * alpha)
    return emb


class NativeUMAP:
    """Drop-in umap.UMAP equivalent for fit_transform.

    Parameters mirror umap-learn's (the subset the reference uses:
    n_neighbors, n_components, min_dist, spread, metric, n_epochs,
    random_state — reference: dashboard/umap_optimized.py:40-49).
    """

    def __init__(
        self,
        n_neighbors: int = 15,
        n_components: int = 2,
        min_dist: float = 0.1,
        spread: float = 1.0,
        metric: str = "euclidean",
        n_epochs: int | None = None,
        negative_sample_rate: int = 5,
        learning_rate: float = 1.0,
        random_state: int = 42,
    ):
        self.n_neighbors = n_neighbors
        self.n_components = n_components
        self.min_dist = min_dist
        self.spread = spread
        self.metric = metric
        self.n_epochs = n_epochs
        self.negative_sample_rate = negative_sample_rate
        self.learning_rate = learning_rate
        self.random_state = random_state
        self.embedding_ = None

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        rng = np.random.default_rng(self.random_state)
        if n <= self.n_components + 1:
            # too few points for a manifold; center-scaled PCA fallback
            from sklearn.decomposition import PCA

            k = min(self.n_components, max(1, n - 1), x.shape[1])
            out = np.zeros((n, self.n_components), np.float32)
            if n > 1:
                out[:, :k] = PCA(n_components=k).fit_transform(x)
            self.embedding_ = out
            return out
        k = int(min(self.n_neighbors, n - 1))
        idx, dist = _knn(
            x, k, self.metric, random_state=self.random_state
        )
        graph = fuzzy_simplicial_set(idx, dist, n)

        n_epochs = self.n_epochs or (500 if n <= 10_000 else 200)
        # drop edges too weak to ever be sampled (umap-learn semantics)
        w = graph.data
        keep = w >= w.max() / float(n_epochs)
        head, tail, w = graph.row[keep], graph.col[keep], w[keep]

        a, b = find_ab_params(self.spread, self.min_dist)
        emb = spectral_init(graph, self.n_components, rng)
        emb = optimize_layout(
            emb,
            head.astype(np.int64),
            tail.astype(np.int64),
            make_epochs_per_sample(w, n_epochs),
            a,
            b,
            n_epochs,
            rng,
            self.negative_sample_rate,
            self.learning_rate,
        )
        self.embedding_ = emb.astype(np.float32)
        return self.embedding_


def UMAP(**kwargs):  # noqa: N802 - mirrors umap.UMAP's name
    """Factory matching umap-learn's constructor signature (extra kwargs
    the native implementation doesn't model, e.g. init/verbose, ignored)."""
    allowed = {
        "n_neighbors", "n_components", "min_dist", "spread", "metric",
        "n_epochs", "negative_sample_rate", "learning_rate", "random_state",
    }
    return NativeUMAP(**{k: v for k, v in kwargs.items() if k in allowed})
