"""DeepEarth in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``deepearth_tpu`` (JAX, the reference) that mirrors its module
names. It imports neither JAX nor the JAX package. Ported so far: the
embedding service (``api.DeepEarth`` and its functional ``init`` /
``register`` / ``predict``, ``registry``, the REST data service and its
client in ``serving``, with the data and evaluation modules they read),
``DeepEarthModel`` with learned-embedding modalities and continuous
modalities through universal-token encoders (MLA + SwiGLU, optionally an MoE
projection), token-major and batch-major fusion, the DeepSeek MLA/MoE
simulator of the flagship (``integrated_config(use_deepseek_fusion=True)``),
the masked-reconstruction train step (``training``) with its data layer
(``data``: synthetic data, the pinned-memory prefetch to the card, echoing,
int8 wire compression, splits, npy datasets, the native gather;
``geospatial``) and command-line entry points (``cli.train``,
``cli.serve``, ``cli.prepare_data``), and language decoding
(``models.DeepSeekForCausalLM``, ``models.generate`` over the compressed MLA
cache, int8 / int4 weights by ``ops.quant``, ``serving.language_server``),
with CUDA kernels for the hash-grid encoding, the token-major pairwise
attention, mid-length and flash attention and the grouped matmul of the
ragged expert path (each forward and backward), and the int8 / int4
fused-dequant matmuls of decode; and the multi-GPU layer (``parallel``:
meshes, JAX's sharding rules, ring attention, the GPipe pipeline;
``training.distributed``: the DistributedTrainer); see ROADMAP.md for what
is still to come.
"""

from .configs import (
    DeepEarthConfig,
    DeepSeekBlockConfig,
    FusionConfig,
    Grid4DConfig,
    HashEncodingConfig,
    MLAConfig,
    ModalityConfig,
    MaskingConfig,
    MoEConfig,
    OptimizerConfig,
    PRESET_MODALITIES,
    RopeScalingConfig,
    ShardingConfig,
    TransformerConfig,
    config_from_json,
    config_to_json,
    integrated_config,
    simulator_config,
    small_config,
    tiny_config,
)
from .convert import (
    flax_params_from_model,
    load_flax_opt_state,
    load_flax_params,
)
from .models import DeepEarthModel

__all__ = [
    "DeepEarthConfig", "DeepSeekBlockConfig", "FusionConfig", "Grid4DConfig",
    "HashEncodingConfig", "MLAConfig", "MaskingConfig", "ModalityConfig",
    "MoEConfig", "OptimizerConfig", "PRESET_MODALITIES", "RopeScalingConfig",
    "ShardingConfig", "TransformerConfig",
    "config_from_json", "config_to_json", "integrated_config",
    "simulator_config", "small_config", "tiny_config",
    "flax_params_from_model",
    "load_flax_opt_state", "load_flax_params", "DeepEarthModel",
]
