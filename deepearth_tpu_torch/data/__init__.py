"""Data layer of the PyTorch port: its own copies of the JAX package's
numpy-only mmap embedding store and observation data engine (the rest of
``deepearth_tpu.data`` is ROADMAP.md Queue 1, item 17)."""

from .mmap_store import (
    MMapEmbeddingLoader,
    MMapEmbeddingWriter,
    convert_arrays_to_store,
)
from .observations import (
    DatasetConfig,
    ObservationDataset,
    UnifiedDataCache,
    VJEPA2_SHAPE,
    image_level_mean,
    reshape_vision_embedding,
    spatial_attention_map,
    spatial_patch,
    temporal_frame,
)

__all__ = [
    "DatasetConfig",
    "ObservationDataset",
    "UnifiedDataCache",
    "VJEPA2_SHAPE",
    "image_level_mean",
    "reshape_vision_embedding",
    "spatial_attention_map",
    "spatial_patch",
    "temporal_frame",
    "MMapEmbeddingLoader",
    "MMapEmbeddingWriter",
    "convert_arrays_to_store",
]
