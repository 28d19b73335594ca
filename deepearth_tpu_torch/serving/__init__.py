"""Serving front ends of the PyTorch port: the language embedding service.
The JAX package's dashboard client and REST data service are not ported yet
(ROADMAP.md Queue 1)."""

from .language_server import (
    DeepSeekEmbedder,
    HashEmbedder,
    HFEmbedder,
    LanguageClient,
    LanguageEmbeddingService,
    LanguageServer,
)

__all__ = [
    "DeepSeekEmbedder",
    "HashEmbedder",
    "HFEmbedder",
    "LanguageClient",
    "LanguageEmbeddingService",
    "LanguageServer",
]
