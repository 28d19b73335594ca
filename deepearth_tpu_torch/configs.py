"""Configuration dataclasses for the PyTorch port, free of JAX.

The fields and ``__post_init__`` derivations are those of
``deepearth_tpu/configs.py`` for every class the model and the train step
read; dtypes are torch dtypes. :func:`config_from_json` reads the JSON that
the JAX package's ``config_to_json`` writes, and :func:`config_to_json`
writes the same schema, so a checkpoint's config travels between the two
packages. The sharding section is kept as data (:class:`ShardingConfig`,
read by nothing until the multi-GPU slice). The presets
(:func:`tiny_config`, :func:`small_config`, :func:`integrated_config` the
flagship, :func:`simulator_config`) are those of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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
class RopeScalingConfig:
    """RoPE scaling family."""

    type: str = "none"  # 'none' | 'linear' | 'dynamic' | 'yarn'
    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass
class MLAConfig:
    """Multi-head Latent Attention."""

    hidden_dim: int = 512
    n_heads: int = 8
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 128
    qk_rope_head_dim: int = 32
    qk_nope_head_dim: int = 64
    v_head_dim: int = 64
    rope_theta: float = 10000.0
    rope_scaling: RopeScalingConfig = field(default_factory=RopeScalingConfig)
    attention_dropout: float = 0.0
    attention_bias: bool = False
    max_position_embeddings: int = 4096
    # on the card, sequences of at least flash_min_seq go to the flash
    # kernel K4
    use_flash_attention: bool = False
    flash_min_seq: int = 1024
    # ring attention over this mesh axis under an ambient mesh
    # (ops.sharding.use_mesh; parallel/ring.py)
    sequence_axis: Optional[str] = None
    ring_batch_axis: str = "data"
    ring_min_seq: int = 512

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass
class MoEConfig:
    """Sigmoid group-limited top-k MoE (``models/deepseek.py`` ``MoELayer``).
    ``dense_all_max_bytes=None`` takes the budget from the device type
    (``models/deepseek.py`` ``dense_all_budget_bytes``)."""

    n_routed_experts: int = 8
    num_experts_per_tok: int = 2
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    n_shared_experts: Optional[int] = 1
    moe_intermediate_size: int = 512
    hidden_dim: int = 512
    capacity_factor: Optional[float] = 2.0
    # 'auto' | 'dense_all' | 'dense' | 'scatter' | 'ragged'
    dispatch_mode: str = "auto"
    aux_loss_weight: float = 0.0
    dense_all_max_bytes: Optional[int] = None
    allow_ragged: bool = True


@dataclass
class DeepSeekBlockConfig:
    """DeepSeek-style decoder stack: MLA attention + (dense | MoE) MLP."""

    hidden_dim: int = 512
    n_layers: int = 4
    intermediate_size: int = 2048
    mla: MLAConfig = None
    moe: Optional[MoEConfig] = None
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    rms_norm_eps: float = 1e-6
    dropout: float = 0.0
    # GPipe over the layer stack: the layers after pipeline_split's prefix
    # in P stages (models/deepseek.py PipelineStages, parallel/pipeline.py)
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0

    def __post_init__(self):
        if self.mla is None:
            self.mla = MLAConfig(hidden_dim=self.hidden_dim)
        if self.moe is not None and self.moe.hidden_dim != self.hidden_dim:
            self.moe = dataclasses.replace(self.moe, hidden_dim=self.hidden_dim)


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
    # DeepSeek MLA/MoE simulator after the fusion stack
    deepseek_block: Optional[DeepSeekBlockConfig] = None


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


# Named modality presets of the JAX package.
PRESET_MODALITIES: Dict[str, ModalityConfig] = {
    "vision_standard": ModalityConfig(
        name="vision", input_dim=1408, n_tokens=16, use_moe_projection=True
    ),
    "vision_satellite": ModalityConfig(
        name="vision", input_dim=1408, n_tokens=64, use_moe_projection=True
    ),
    "language_standard": ModalityConfig(
        name="language", input_dim=7168, n_tokens=4, use_moe_projection=True
    ),
    "weather": ModalityConfig(name="weather", input_dim=5, n_tokens=1),
    "soil": ModalityConfig(name="soil", input_dim=10, n_tokens=1),
    "species": ModalityConfig(
        name="species",
        encoding_type="learned_embedding",
        input_type="categorical",
        vocab_size=232,
        n_tokens=1,
    ),
    "ndvi_timeseries": ModalityConfig(name="ndvi", input_dim=24, n_tokens=2),
    "hyperspectral": ModalityConfig(
        name="hyperspectral", input_dim=224, n_tokens=4, use_moe_projection=True
    ),
}


@dataclass
class MaskingConfig:
    """Masked-reconstruction objectives; probabilities of hiding an entry."""

    spatial_mask_prob: float = 0.15
    temporal_mask_prob: float = 0.15
    modality_mask_prob: float = 0.15  # whole-modality masking default
    vision_patch_mask_prob: float = 0.75  # MAE-style
    language_token_mask_prob: float = 0.15  # MLM-style


@dataclass
class OptimizerConfig:
    """AdamW with a learning-rate schedule (training/trainer.py)."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1  # > 1: MultiSteps gradient accumulation
    moment_dtype: str = "float32"  # first moment: 'float32' | 'bfloat16'
    second_moment: str = "float32"  # 'float32' | 'bfloat16' | 'factored'
    fused: bool = True  # the port has the fused AdamW only
    b1: float = 0.9
    b2: float = 0.999
    schedule: str = "cosine"  # 'cosine' | 'onecycle' | 'constant'


@dataclass
class ShardingConfig:
    """Mesh layout: axes data / expert / model. ``mesh_shape``, where set,
    is the default mesh's shape of ``training.distributed``'s trainer
    (``parallel.create_mesh``); the axis names are JAX's, kept so that a
    config's JSON is the JAX package's."""

    data_axis: str = "data"
    expert_axis: str = "expert"
    model_axis: str = "model"
    mesh_shape: Optional[Tuple[int, ...]] = None


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

    masking: MaskingConfig = field(default_factory=MaskingConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)

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
# Presets
# --------------------------------------------------------------------------- #


def tiny_config(**overrides) -> DeepEarthConfig:
    """Tiny end-to-end config: hidden 128, 4 heads, 2 fusion layers, Grid4D
    8 + 4 levels on 2^14 tables, and a ``species`` source (vocab 232)."""
    cfg = DeepEarthConfig(
        hidden_dim=128,
        n_heads=4,
        n_layers=2,
        grid4d=Grid4DConfig(
            n_spatial_levels=8,
            n_temporal_levels=4,
            n_features_per_level=2,
            hash_table_size=2 ** 14,
        ),
        modality_encoder=TransformerConfig(hidden_dim=64, n_heads=4, n_layers=1),
        **overrides,
    )
    cfg.add_modality(
        ModalityConfig(
            name="species",
            encoding_type="learned_embedding",
            input_type="categorical",
            vocab_size=232,
        )
    )
    return cfg


def small_config(**overrides) -> DeepEarthConfig:
    """The A-stack's default scale: :class:`DeepEarthConfig`'s defaults."""
    return DeepEarthConfig(**overrides)


def integrated_config(
    universal_dim: int = 2048,
    num_fusion_layers: int = 24,
    use_deepseek_fusion: bool = False,
    **overrides,
) -> DeepEarthConfig:
    """The flagship: 2048-d universal tokens, 24 fusion layers, vision and
    language through MoE-projected universal-token encoders; with
    ``use_deepseek_fusion`` a 24-layer MLA + MoE simulator (8 experts, top-2
    in 2 groups, one shared expert) after the fusion stack."""
    ds = None
    if use_deepseek_fusion:
        ds = DeepSeekBlockConfig(
            hidden_dim=universal_dim,
            n_layers=num_fusion_layers,
            intermediate_size=universal_dim * 4,
            mla=MLAConfig(
                hidden_dim=universal_dim,
                n_heads=16,
                q_lora_rank=universal_dim // 2,
                kv_lora_rank=512,
                qk_rope_head_dim=64,
                qk_nope_head_dim=128,
                v_head_dim=128,
            ),
            moe=MoEConfig(
                n_routed_experts=8,
                num_experts_per_tok=2,
                n_group=2,
                topk_group=1,
                moe_intermediate_size=universal_dim,
                hidden_dim=universal_dim,
            ),
        )
    cfg = DeepEarthConfig(
        hidden_dim=universal_dim,
        n_heads=16,
        n_layers=num_fusion_layers,
        fusion=FusionConfig(
            universal_dim=universal_dim,
            num_fusion_layers=num_fusion_layers,
            num_heads=16,
            deepseek_block=ds,
        ),
        **overrides,
    )
    cfg.add_modality(dataclasses.replace(PRESET_MODALITIES["vision_standard"]))
    cfg.add_modality(dataclasses.replace(PRESET_MODALITIES["language_standard"]))
    return cfg


# Inductive-simulator presets of the JAX package.
SIMULATOR_PRESETS: Dict[str, Dict[str, int]] = {
    "standard": dict(n_layers=24, hidden_dim=2048, n_heads=16, n_experts=8),
    "high_precision": dict(n_layers=32, hidden_dim=2560, n_heads=20, n_experts=16),
    "fast": dict(n_layers=12, hidden_dim=1024, n_heads=8, n_experts=4),
    "ultra": dict(n_layers=48, hidden_dim=4096, n_heads=32, n_experts=128),
}


def simulator_config(preset: str = "standard") -> DeepSeekBlockConfig:
    p = SIMULATOR_PRESETS[preset]
    return DeepSeekBlockConfig(
        hidden_dim=p["hidden_dim"],
        n_layers=p["n_layers"],
        intermediate_size=p["hidden_dim"] * 4,
        mla=MLAConfig(
            hidden_dim=p["hidden_dim"],
            n_heads=p["n_heads"],
            kv_lora_rank=min(512, p["hidden_dim"] // 4),
            qk_rope_head_dim=64,
            qk_nope_head_dim=128,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_routed_experts=p["n_experts"],
            num_experts_per_tok=min(2, p["n_experts"]),
            moe_intermediate_size=p["hidden_dim"],
            hidden_dim=p["hidden_dim"],
        ),
    )


# --------------------------------------------------------------------------- #
# JSON in the schema of deepearth_tpu.configs.config_to_json
# --------------------------------------------------------------------------- #

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

_CLASSES = {
    c.__name__: c
    for c in (HashEncodingConfig, Grid4DConfig, TransformerConfig,
              RopeScalingConfig, MLAConfig, MoEConfig, DeepSeekBlockConfig,
              FusionConfig, ModalityConfig, MaskingConfig, OptimizerConfig,
              ShardingConfig, DeepEarthConfig)
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _encode(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": type(obj).__name__,
                **{f.name: _encode(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, torch.dtype):
        return {"__dtype__": _DTYPE_NAMES[obj]}
    return obj


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


def config_to_json(cfg: DeepEarthConfig, path: Optional[str] = None) -> str:
    """Serialize a config to the JSON schema of the JAX package's
    ``config_to_json`` (optionally also to a file); the JAX package's
    ``config_from_json`` reads it back."""
    payload = json.dumps(_encode(cfg), indent=2)
    if path:
        with open(path, "w") as f:
            f.write(payload)
    return payload
