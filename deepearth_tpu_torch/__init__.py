"""DeepEarth in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``deepearth_tpu`` (JAX, the reference) that mirrors its module
names. It imports neither JAX nor the JAX package. Ported so far: the
inference forward of ``DeepEarthModel`` for learned-embedding modalities,
with CUDA kernels for the hash-grid encoding and the token-major pairwise
attention (see ROADMAP.md for what is still to come).
"""

from .configs import (
    DeepEarthConfig,
    FusionConfig,
    Grid4DConfig,
    HashEncodingConfig,
    ModalityConfig,
    TransformerConfig,
    config_from_json,
)
from .convert import load_flax_params
from .models import DeepEarthModel

__all__ = [
    "DeepEarthConfig", "FusionConfig", "Grid4DConfig", "HashEncodingConfig",
    "ModalityConfig", "TransformerConfig", "config_from_json",
    "load_flax_params", "DeepEarthModel",
]
