"""Serving front ends of the PyTorch port: the REST data service
(``server.DataService``, ``server.DashboardServer``), its client
(``client.DashboardClient``), and the language embedding service."""

from .client import DashboardClient
from .language_server import (
    DeepSeekEmbedder,
    HashEmbedder,
    HFEmbedder,
    LanguageClient,
    LanguageEmbeddingService,
    LanguageServer,
)
from .server import DashboardServer, DataService

__all__ = [
    "DeepSeekEmbedder",
    "DashboardClient",
    "DashboardServer",
    "DataService",
    "HashEmbedder",
    "HFEmbedder",
    "LanguageClient",
    "LanguageEmbeddingService",
    "LanguageServer",
]
