"""Evaluation layer of the PyTorch port: its own copies of the JAX
package's numpy-only ecosystem, retrieval and spatiotemporal metrics (the
linear probes are ROADMAP.md Queue 1, item 18)."""

from .ecosystems import (
    EcosystemCluster,
    analyze_ecosystems,
    ecosystem_map_html,
    species_similarity,
)
from .retrieval import cross_modal_retrieval, retrieval_metrics
from .spatiotemporal import (
    SpatiotemporalMetrics,
    binned_rmse,
    knn_weights,
    morans_i,
    temporal_consistency,
)

__all__ = [
    "cross_modal_retrieval",
    "retrieval_metrics",
    "EcosystemCluster",
    "analyze_ecosystems",
    "ecosystem_map_html",
    "species_similarity",
    "SpatiotemporalMetrics",
    "binned_rmse",
    "knn_weights",
    "morans_i",
    "temporal_consistency",
]
