"""Data layer of the PyTorch port: the synthetic generator, the mmap
embedding store, the observation data engine, batching with the pinned-memory
prefetch to the card, int8 wire compression, train/test splits and the npy
dataset, and the frozen-backbone extractors. The numpy modules are the
port's own copies of the JAX package's."""

from .extractors import (
    BaseModalityExtractor,
    LanguageModelExtractor,
    StubExtractor,
    VJEPA2Extractor,
    run_parallel_extraction,
)
from .batches import (
    collate_observations,
    device_prefetch,
    echo_on_device,
    threaded_producer,
)
from .transfer import (
    compress_batch,
    decompress_on_device,
    device_prefetch_compressed,
    quantize_rows,
)
from .npy_dataset import NpySampleDataset, write_npy_dataset
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
from .mmap_store import (
    MMapEmbeddingLoader,
    MMapEmbeddingWriter,
    convert_arrays_to_store,
)
from .splits import (
    SplitConfig,
    create_spatial_temporal_split,
    haversine_km,
    load_split,
    save_split,
)
from .synthetic import (
    SyntheticConfig,
    SyntheticEarthDataGenerator,
    observations_to_batch,
)

__all__ = [
    "BaseModalityExtractor",
    "LanguageModelExtractor",
    "StubExtractor",
    "VJEPA2Extractor",
    "run_parallel_extraction",
    "NpySampleDataset",
    "write_npy_dataset",
    "DatasetConfig",
    "ObservationDataset",
    "UnifiedDataCache",
    "VJEPA2_SHAPE",
    "image_level_mean",
    "reshape_vision_embedding",
    "spatial_attention_map",
    "spatial_patch",
    "temporal_frame",
    "collate_observations",
    "device_prefetch",
    "device_prefetch_compressed",
    "echo_on_device",
    "compress_batch",
    "decompress_on_device",
    "quantize_rows",
    "threaded_producer",
    "MMapEmbeddingLoader",
    "MMapEmbeddingWriter",
    "convert_arrays_to_store",
    "SplitConfig",
    "create_spatial_temporal_split",
    "haversine_km",
    "load_split",
    "save_split",
    "SyntheticConfig",
    "SyntheticEarthDataGenerator",
    "observations_to_batch",
]
