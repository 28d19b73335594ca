from .attention_smallseq import (
    pairwise_token_attention,
    pairwise_token_attention_bwd_plain,
    pairwise_token_attention_plain,
    rope_token_major,
)
from .hash_encoding import (
    HashEncoding,
    hash_encode,
    hash_encode_bwd_plain,
    hash_encode_plain,
    hash_grid_indices,
    init_hash_tables,
)

__all__ = [
    "pairwise_token_attention", "pairwise_token_attention_bwd_plain",
    "pairwise_token_attention_plain", "rope_token_major", "HashEncoding",
    "hash_encode", "hash_encode_bwd_plain", "hash_encode_plain",
    "hash_grid_indices", "init_hash_tables",
]
