from .attention import dot_product_attention
from .attention_smallseq import (
    pairwise_token_attention,
    pairwise_token_attention_bwd_plain,
    pairwise_token_attention_plain,
    rope_token_major,
)
from .attention_vmem import supported, vmem_attention, vmem_attention_plain
from .hash_encoding import (
    HashEncoding,
    hash_encode,
    hash_encode_bwd_plain,
    hash_encode_plain,
    hash_grid_indices,
    init_hash_tables,
)
from .norms import RMSNorm
from .rope import (
    apply_rope_deepseek,
    apply_rope_half,
    apply_rope_interleaved,
    rope_cos_sin,
    rope_inv_freq,
    rotate_half,
)

__all__ = [
    "dot_product_attention", "pairwise_token_attention",
    "pairwise_token_attention_bwd_plain", "pairwise_token_attention_plain",
    "rope_token_major", "supported", "vmem_attention",
    "vmem_attention_plain", "HashEncoding", "hash_encode",
    "hash_encode_bwd_plain", "hash_encode_plain", "hash_grid_indices",
    "init_hash_tables", "RMSNorm", "apply_rope_deepseek", "apply_rope_half",
    "apply_rope_interleaved", "rope_cos_sin", "rope_inv_freq", "rotate_half",
]
