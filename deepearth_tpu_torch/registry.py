"""Runtime data-source registry with shape adapters: the PyTorch port of
``deepearth_tpu/registry.py`` (reference: core/data_registry.py:140-478).

Register arbitrary data sources at runtime; the registry derives a
ModalityConfig per source (auto encoder/decoder sizing), applies shape
adapters (vector→image grid, timeseries→image), and can instantiate the
port's DeepEarthModel wired to all registered sources on a given device
(reference: create_deepearth_with_registry, core/data_registry.py:360).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import DeepEarthConfig, ModalityConfig
from .models import DeepEarthModel


# --------------------------------------------------------------------------- #
# Adapters (reference: core/data_registry.py:140-188)
# --------------------------------------------------------------------------- #


def vector_to_image(vec: np.ndarray, size: Optional[int] = None) -> np.ndarray:
    """(..., D) → (..., H, W, 1) square grid, zero-padded."""
    d = vec.shape[-1]
    size = size or int(math.ceil(math.sqrt(d)))
    pad = size * size - d
    flat = np.concatenate(
        [vec, np.zeros(vec.shape[:-1] + (pad,), vec.dtype)], axis=-1
    )
    return flat.reshape(vec.shape[:-1] + (size, size, 1))


def timeseries_to_image(ts: np.ndarray) -> np.ndarray:
    """(..., T, C) → (..., T, C, 1) image-like layout."""
    return ts[..., None]


ADAPTERS: Dict[str, Callable[..., np.ndarray]] = {
    "vector_to_image": vector_to_image,
    "timeseries_to_image": timeseries_to_image,
    "identity": lambda x: x,
}


@dataclass
class DataSource:
    name: str
    shape: Tuple[int, ...]
    source_type: str  # 'vector' | 'timeseries' | 'image' | 'categorical'
    num_classes: Optional[int] = None
    adapter: str = "identity"
    description: str = ""

    @property
    def flat_dim(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


class DataSourceRegistry:
    """Registry of runtime-registered sources → modality configs
    (reference: core/data_registry.py:190-360)."""

    def __init__(self):
        self.sources: Dict[str, DataSource] = {}

    def register_data_source(
        self,
        name: str,
        shape: Sequence[int] = (),
        source_type: str = "vector",
        num_classes: Optional[int] = None,
        adapter: str = "identity",
        description: str = "",
    ) -> DataSource:
        if adapter not in ADAPTERS:
            raise ValueError(f"unknown adapter {adapter!r}; have {list(ADAPTERS)}")
        if source_type == "categorical" and num_classes is None:
            raise ValueError("categorical sources need num_classes")
        src = DataSource(
            name=name,
            shape=tuple(int(s) for s in shape),
            source_type=source_type,
            num_classes=num_classes,
            adapter=adapter,
            description=description,
        )
        self.sources[name] = src
        return src

    def apply_adapter(self, name: str, data: np.ndarray) -> np.ndarray:
        return ADAPTERS[self.sources[name].adapter](np.asarray(data))

    def modality_config(self, name: str) -> ModalityConfig:
        """Auto encoder/decoder sizing (reference heuristics:
        encoders/universal_encoder.py:252 auto-MoE when input_dim>100)."""
        src = self.sources[name]
        if src.source_type == "categorical":
            return ModalityConfig(
                name=name, encoding_type="learned_embedding",
                input_type="categorical", vocab_size=src.num_classes,
            )
        dim = src.flat_dim
        n_tokens = 1
        if src.source_type == "image" or dim > 1024:
            n_tokens = 4
        elif src.source_type == "timeseries":
            n_tokens = 2
        return ModalityConfig(
            name=name,
            input_dim=dim if src.source_type != "timeseries" else src.shape[-1],
            n_tokens=n_tokens,
            use_moe_projection=dim > 100,
            encoder_layers=1 if dim <= 256 else 2,
            encoder_heads=4,
        )

    def build_config(self, base: Optional[DeepEarthConfig] = None) -> DeepEarthConfig:
        cfg = base or DeepEarthConfig()
        for name in self.sources:
            cfg.add_modality(self.modality_config(name))
        return cfg


def create_deepearth_with_registry(
    registry: DataSourceRegistry,
    base: Optional[DeepEarthConfig] = None,
    *,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Tuple[DeepEarthModel, DeepEarthConfig]:
    """The model over every registered source and its config (reference:
    core/data_registry.py:360). Its parameters are drawn from ``generator``
    (seed 0 on ``device`` if none is given) on ``device``: the card unless
    the caller names another (``device="cpu"``)."""
    cfg = registry.build_config(base)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return DeepEarthModel(cfg, generator=generator, device=device), cfg
