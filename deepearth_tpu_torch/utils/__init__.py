"""Utilities of the PyTorch port (own copies of the JAX package's numpy-only
helpers)."""

from .logging import get_logger
from .projection import EmbeddingProjector

__all__ = ["get_logger", "EmbeddingProjector"]
