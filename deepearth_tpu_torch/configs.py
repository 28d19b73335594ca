"""Configuration dataclasses for the PyTorch port, free of JAX.

The fields and ``__post_init__`` derivations are those of
``deepearth_tpu/configs.py`` for every class the inference forward reads;
dtypes are torch dtypes. :func:`config_from_json` reads the JSON that the JAX
package's ``config_to_json`` writes, so a checkpoint's config travels between
the two packages. Sections the forward does not read (masking, optimizer,
sharding, the DeepSeek fusion block) are kept as plain dicts.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclass
class HashEncodingConfig:
    """Multi-resolution hash encoding (one level stack)."""

    n_levels: int = 16
    n_features_per_level: int = 2
    coords_dim: int = 3
    hash_table_size: int = 2 ** 19
    base_resolution: int = 16
    finest_resolution: Optional[int] = None  # if set, geometric growth to it
    resolutions: Optional[List[int]] = None  # explicit override
    interpolation: str = "linear"  # 'linear' (d-linear) | 'nearest'

    def __post_init__(self):
        if self.resolutions is None:
            if self.finest_resolution is not None and self.n_levels > 1:
                growth = (self.finest_resolution / self.base_resolution) ** (
                    1.0 / (self.n_levels - 1)
                )
                self.resolutions = [
                    int(round(self.base_resolution * growth ** i))
                    for i in range(self.n_levels)
                ]
            else:
                start = int(math.log2(self.base_resolution))
                self.resolutions = [2 ** (start + i) for i in range(self.n_levels)]
        self.resolutions = list(self.resolutions)[: self.n_levels]

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features_per_level


@dataclass
class Grid4DConfig:
    """Grid4D spacetime encoder: xyz + t hash grids, optional xyt/yzt/xzt
    decompositions, or the table-free 'sincos' variant."""

    spatial: HashEncodingConfig = None
    temporal: HashEncodingConfig = None
    use_decompositions: bool = False
    decomposition: HashEncodingConfig = None  # shared config for xyt/yzt/xzt

    n_spatial_levels: int = 16
    n_temporal_levels: int = 8
    n_features_per_level: int = 2
    hash_table_size: int = 2 ** 19

    encoding_mode: str = "hash"  # 'hash' | 'sincos'
    time_span_seconds: float = 86400.0 * 365.25 * 15
    spatial_span_meters: float = 100_000.0
    spatial_scales_m: Tuple[float, ...] = (10.0, 100.0, 1000.0)
    sincos_feat_dim: int = 128
    sincos_mlp_dim: int = 512

    def __post_init__(self):
        if self.spatial is None:
            self.spatial = HashEncodingConfig(
                n_levels=self.n_spatial_levels,
                n_features_per_level=self.n_features_per_level,
                coords_dim=3,
                hash_table_size=self.hash_table_size,
                base_resolution=16,
            )
        if self.temporal is None:
            # the 1-D time table is a quarter of the spatial one
            self.temporal = HashEncodingConfig(
                n_levels=self.n_temporal_levels,
                n_features_per_level=self.n_features_per_level,
                coords_dim=1,
                hash_table_size=self.hash_table_size // 4,
                base_resolution=4,
            )
        if self.use_decompositions and self.decomposition is None:
            self.decomposition = HashEncodingConfig(
                n_levels=self.n_spatial_levels // 2,
                n_features_per_level=self.n_features_per_level,
                coords_dim=3,
                hash_table_size=self.hash_table_size // 2,
                base_resolution=16,
            )

    @property
    def output_dim(self) -> int:
        dim = self.spatial.output_dim + self.temporal.output_dim
        if self.use_decompositions:
            dim += 3 * self.decomposition.output_dim
        return dim


@dataclass
class TransformerConfig:
    """Dense transformer block configuration."""

    hidden_dim: int = 768
    n_heads: int = 12
    n_layers: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    attention_dropout: float = 0.0
    layer_norm_eps: float = 1e-6
    use_rope: bool = True
    rope_variant: str = "interleaved"
    use_gated_mlp: bool = False
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.n_heads


@dataclass
class FusionConfig:
    """Cross-modal fusion stack."""

    universal_dim: int = 2048
    num_fusion_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    attention_dropout: float = 0.0
    layer_norm_eps: float = 1e-6
    use_rotary_embeddings: bool = True
    use_gated_mlp: bool = True
    cross_attention_freq: int = 3
    # 'inputs': cross-attention attends to the pre-fusion embedded tokens;
    # 'self': to the running hidden states
    cross_attention_context: str = "inputs"
    # token counts at or below this run token-major (N, B, D)
    token_major_max_tokens: int = 8
    spatial_aware: bool = True
    temporal_aware: bool = True
    remat: bool = False
    remat_policy: str = "full"
    max_seq_length: int = 8192
    max_spatial_resolution: int = 64
    # DeepSeek MLA/MoE fusion blocks, kept as plain data (not on this port yet)
    deepseek_block: Optional[Dict[str, Any]] = None


@dataclass
class ModalityConfig:
    """Per-modality configuration."""

    name: str = ""
    encoding_type: str = "continuous_values"
    input_type: str = "numerical"
    input_dim: int = 1
    vocab_size: Optional[int] = None
    n_tokens: int = 1
    column_name: Optional[str] = None
    column_names: Optional[List[str]] = None
    decode_sequence: bool = False
    use_moe_projection: bool = False
    encoder_layers: int = 2
    encoder_heads: int = 8
    encoder_remat: bool = False
    encoder_remat_policy: str = "full"
    encoder_sequence_axis: Optional[str] = None
    encoder_ring_min_seq: int = 512
    loss_weight: float = 1.0
    mask_prob: float = 0.15


@dataclass
class DeepEarthConfig:
    """Main configuration."""

    grid4d: Grid4DConfig = field(default_factory=Grid4DConfig)

    hidden_dim: int = 768
    n_heads: int = 12
    n_layers: int = 12

    modalities: Dict[str, ModalityConfig] = field(default_factory=dict)

    modality_encoder: TransformerConfig = None
    fusion: FusionConfig = None

    # training-side sections, kept as plain data
    masking: Dict[str, Any] = field(default_factory=dict)
    optimizer: Dict[str, Any] = field(default_factory=dict)
    sharding: Dict[str, Any] = field(default_factory=dict)

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.modality_encoder is None:
            self.modality_encoder = TransformerConfig(
                hidden_dim=self.hidden_dim // 2, n_heads=6, n_layers=4
            )
        if self.fusion is None:
            self.fusion = FusionConfig(
                universal_dim=self.hidden_dim,
                num_fusion_layers=self.n_layers,
                num_heads=self.n_heads,
            )

    def add_modality(self, cfg: ModalityConfig) -> "DeepEarthConfig":
        self.modalities[cfg.name] = cfg
        return self


# --------------------------------------------------------------------------- #
# JSON written by deepearth_tpu.configs.config_to_json
# --------------------------------------------------------------------------- #

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

_CLASSES = {
    c.__name__: c
    for c in (HashEncodingConfig, Grid4DConfig, TransformerConfig,
              FusionConfig, ModalityConfig, DeepEarthConfig)
}


def _decode(obj):
    if isinstance(obj, dict):
        if "__dtype__" in obj:
            return _DTYPES[obj["__dtype__"]]
        fields = {k: _decode(v) for k, v in obj.items() if k != "__dataclass__"}
        cls = _CLASSES.get(obj.get("__dataclass__"))
        if cls is None:
            # plain dicts, and sections this port keeps as data
            return fields
        init = {f.name for f in dataclasses.fields(cls) if f.init}
        return cls(**{k: v for k, v in fields.items() if k in init})
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def config_from_json(source: str) -> DeepEarthConfig:
    """Rebuild a config from the JAX package's ``config_to_json`` output,
    given as a JSON string or a path to a file holding one."""
    if os.path.exists(source):
        with open(source) as f:
            source = f.read()
    return _decode(json.loads(source))
