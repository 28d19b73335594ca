"""Utilities of the PyTorch port (own copies of the JAX package's numpy-only
helpers)."""

from .logging import (
    JSONLMetricWriter,
    MultiWriter,
    TensorBoardMetricWriter,
    get_logger,
    setup_logging,
)
from .projection import EmbeddingProjector

__all__ = [
    "get_logger",
    "setup_logging",
    "JSONLMetricWriter",
    "TensorBoardMetricWriter",
    "MultiWriter",
    "EmbeddingProjector",
]
