"""DeepEarth in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``deepearth_tpu`` (JAX, the reference) that mirrors its module
names. It imports neither JAX nor the JAX package. Ported so far:
``DeepEarthModel`` for learned-embedding modalities and its masked-
reconstruction train step (``training``), with CUDA kernels for the
hash-grid encoding and the token-major pairwise attention, forward and
backward (see ROADMAP.md for what is still to come).
"""

from .configs import (
    DeepEarthConfig,
    FusionConfig,
    Grid4DConfig,
    HashEncodingConfig,
    ModalityConfig,
    MaskingConfig,
    OptimizerConfig,
    TransformerConfig,
    config_from_json,
    config_to_json,
)
from .convert import (
    flax_params_from_model,
    load_flax_opt_state,
    load_flax_params,
)
from .models import DeepEarthModel

__all__ = [
    "DeepEarthConfig", "FusionConfig", "Grid4DConfig", "HashEncodingConfig",
    "MaskingConfig", "ModalityConfig", "OptimizerConfig", "TransformerConfig",
    "config_from_json", "config_to_json", "flax_params_from_model",
    "load_flax_opt_state", "load_flax_params", "DeepEarthModel",
]
