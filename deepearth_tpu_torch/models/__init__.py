from .bidirectional import (
    BidirectionalReconstructor,
    MultimodalAutoencoder,
    VisionSequenceDecoder,
)
from .decoders import ModalityDecoder, SpatiotemporalDecoder
from .deepearth import DeepEarthModel
from .deepseek import (
    DeepSeekBlock,
    DeepSeekForCausalLM,
    DeepSeekForSequenceClassification,
    DeepSeekTransformer,
    MLAttention,
    MoELayer,
    SwiGLUMLP,
    collect_moe_aux_losses,
    remat_wrap,
    select_dispatch_mode,
)
from .encoders import ModalityEncoder, UniversalTokenEncoder
from .fusion import (
    CrossModalFusion,
    FusionAttention,
    FusionLayer,
    HierarchicalFusion,
    SpatialTemporalEmbedding,
)
from .generation import causal_lm_decode_step, generate
from .grid4d import Grid4DEncoder
from .hf_convert import (
    config_from_hf,
    convert_hf_state_dict,
    load_hf_checkpoint,
)
from .mla_decode import (
    MLACache,
    cache_bytes_per_token,
    decode_sequence,
    decode_step,
    full_cache_bytes_per_token,
    init_cache,
)
from .mlp_unet import (
    BimodalMLPUNet,
    MLPUNet,
    MultimodalUNet,
    input_feature_mask,
    species_topk,
)
from .shared_space import LatentPool, MultimodalSharedSpace
from .simulator import (
    DatasetSpecificDecoder,
    InductiveSimulator,
    MaskingStrategy,
    create_inductive_simulator,
)
from .transformer import (
    GatedMLP,
    KernelParam,
    MLP,
    MultiHeadAttention,
    Transformer,
    TransformerBlock,
)

__all__ = [
    "ModalityDecoder", "SpatiotemporalDecoder", "DeepEarthModel",
    "DeepSeekBlock", "DeepSeekForCausalLM",
    "DeepSeekForSequenceClassification", "DeepSeekTransformer",
    "MLAttention", "MoELayer",
    "SwiGLUMLP", "collect_moe_aux_losses", "select_dispatch_mode",
    "UniversalTokenEncoder", "CrossModalFusion", "FusionAttention",
    "FusionLayer", "SpatialTemporalEmbedding", "Grid4DEncoder",
    "config_from_hf", "convert_hf_state_dict", "load_hf_checkpoint",
    "GatedMLP",
    "KernelParam", "MLP", "causal_lm_decode_step", "generate", "MLACache",
    "cache_bytes_per_token", "decode_sequence", "decode_step",
    "full_cache_bytes_per_token", "init_cache", "remat_wrap",
    "BidirectionalReconstructor", "MultimodalAutoencoder",
    "VisionSequenceDecoder", "ModalityEncoder", "HierarchicalFusion",
    "BimodalMLPUNet", "MLPUNet", "MultimodalUNet", "input_feature_mask",
    "species_topk", "LatentPool", "MultimodalSharedSpace",
    "DatasetSpecificDecoder", "InductiveSimulator", "MaskingStrategy",
    "create_inductive_simulator", "MultiHeadAttention", "Transformer",
    "TransformerBlock",
]
