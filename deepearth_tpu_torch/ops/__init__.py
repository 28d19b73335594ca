from .attention import dot_product_attention
from .attention_smallseq import (
    pairwise_token_attention,
    pairwise_token_attention_bwd_plain,
    pairwise_token_attention_plain,
    rope_token_major,
)
from .attention_vmem import (
    supported,
    vmem_attention,
    vmem_attention_bwd_plain,
    vmem_attention_plain,
)
# ops.flash_attention stays the module (its function flash_attention would
# shadow it here), as ops.attention_vmem is
from .flash_attention import flash_attention_bwd_plain, flash_attention_plain
from .grouped_matmul import gmm, gmm_bwd_plain, gmm_plain
from .hash_encoding import (
    HASH_PRIMES,
    HashEncoding,
    hash_encode,
    hash_encode_bwd_plain,
    hash_encode_plain,
    hash_grid_indices,
    init_hash_tables,
)
from .moe import (
    GateResult,
    dense_all_expert_ffn,
    expert_ffn,
    load_balance_aux_loss,
    make_dispatch_combine,
    moe_gate,
    position_in_expert,
    ragged_expert_ffn,
    scatter_dispatch_ffn,
)
from .norms import RMSNorm
from .quant import (
    dequantize,
    dequantize_int4,
    expert_ffn_q,
    int4_bmm,
    int4_bmm_plain,
    int4_matmul,
    int8_bmm,
    int8_bmm_plain,
    int8_matmul,
    linear_p,
    quantize_decoder_params,
    quantize_int4,
    quantize_int8,
    quantized_bytes,
)
from .rope import (
    apply_rope_deepseek,
    apply_rope_half,
    apply_rope_interleaved,
    rope_cos_sin,
    rope_inv_freq,
    rotate_half,
    yarn_get_mscale,
)

__all__ = [
    "dot_product_attention", "pairwise_token_attention",
    "pairwise_token_attention_bwd_plain", "pairwise_token_attention_plain",
    "rope_token_major", "supported", "vmem_attention",
    "vmem_attention_bwd_plain", "vmem_attention_plain", "flash_attention",
    "flash_attention_bwd_plain", "flash_attention_plain", "gmm",
    "gmm_bwd_plain", "gmm_plain", "HASH_PRIMES", "HashEncoding", "hash_encode",
    "hash_encode_bwd_plain", "hash_encode_plain", "hash_grid_indices",
    "init_hash_tables", "GateResult", "dense_all_expert_ffn", "expert_ffn",
    "load_balance_aux_loss", "make_dispatch_combine", "moe_gate",
    "position_in_expert", "ragged_expert_ffn", "scatter_dispatch_ffn",
    "RMSNorm", "dequantize", "dequantize_int4", "expert_ffn_q", "int4_bmm",
    "int4_bmm_plain", "int4_matmul", "int8_bmm", "int8_bmm_plain",
    "int8_matmul", "linear_p", "quantize_decoder_params", "quantize_int4",
    "quantize_int8", "quantized_bytes", "apply_rope_deepseek", "apply_rope_half",
    "apply_rope_interleaved", "rope_cos_sin", "rope_inv_freq", "rotate_half",
    "yarn_get_mscale",
]
