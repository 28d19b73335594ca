"""Utilities of the PyTorch port: logging, profiling, resource monitoring,
embedding projection, the wandb-compatible metric sink and the artifacts'
round stamp (own copies of the JAX package's numpy-only helpers), and the
export functions, re-exported from the package's ``export`` as the JAX
package re-exports them."""

from .logging import (
    JSONLMetricWriter,
    MultiWriter,
    TensorBoardMetricWriter,
    get_logger,
    setup_logging,
)
# export lives at the package top level (deepearth_tpu_torch/export.py);
# these re-exports keep the utils-path imports of the JAX package working.
from ..export import export_forward, export_model_forward, load_exported
from .monitor import ResourceMonitor, resource_snapshot
from .profiling import StepTimer, benchmark_fn, trace
from .projection import EmbeddingProjector
from .wandb_sink import WandbSink

__all__ = [
    "export_forward",
    "export_model_forward",
    "load_exported",
    "ResourceMonitor",
    "resource_snapshot",
    "StepTimer",
    "benchmark_fn",
    "trace",
    "get_logger",
    "setup_logging",
    "JSONLMetricWriter",
    "TensorBoardMetricWriter",
    "MultiWriter",
    "EmbeddingProjector",
    "WandbSink",
]
