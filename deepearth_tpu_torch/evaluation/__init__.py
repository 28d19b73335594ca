"""Evaluation layer of the PyTorch port: linear probes on frozen features
(trained with torch, on the card by default), and its own copies of the JAX
package's numpy-only ecosystem, retrieval and spatiotemporal metrics."""

from .probes import (
    DeepEarthEvaluator,
    ProbeResult,
    classification_metrics,
    regression_metrics,
)
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
    "DeepEarthEvaluator",
    "ProbeResult",
    "classification_metrics",
    "regression_metrics",
    "SpatiotemporalMetrics",
    "binned_rmse",
    "knn_weights",
    "morans_i",
    "temporal_consistency",
]
