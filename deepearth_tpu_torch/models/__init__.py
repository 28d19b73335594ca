from .decoders import ModalityDecoder, SpatiotemporalDecoder
from .deepearth import DeepEarthModel
from .deepseek import (
    DeepSeekBlock,
    DeepSeekTransformer,
    MLAttention,
    MoELayer,
    SwiGLUMLP,
    collect_moe_aux_losses,
    select_dispatch_mode,
)
from .encoders import UniversalTokenEncoder
from .fusion import (
    CrossModalFusion,
    FusionAttention,
    FusionLayer,
    SpatialTemporalEmbedding,
)
from .grid4d import Grid4DEncoder
from .transformer import GatedMLP, KernelParam, MLP

__all__ = [
    "ModalityDecoder", "SpatiotemporalDecoder", "DeepEarthModel",
    "DeepSeekBlock", "DeepSeekTransformer", "MLAttention", "MoELayer",
    "SwiGLUMLP", "collect_moe_aux_losses", "select_dispatch_mode",
    "UniversalTokenEncoder", "CrossModalFusion", "FusionAttention",
    "FusionLayer", "SpatialTemporalEmbedding", "Grid4DEncoder", "GatedMLP",
    "KernelParam", "MLP",
]
