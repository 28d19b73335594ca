"""Modality encoders, PyTorch port of ``deepearth_tpu/models/encoders.py``:
the A-stack's ``ModalityEncoder``, ``UniversalTokenEncoder`` and
``_CrossAttention``.

``ModalityEncoder`` projects one (B, input_dim) vector per observation, adds
a learned modality embedding, runs a one-token ``Transformer`` (the (B,)
mask as its key mask: a masked observation's attention outputs zeros),
projects to the output dim and LayerNorms with eps 1e-5, torch's default,
which the JAX package keeps for parity with the reference.

The universal-token encoder: native embeddings (B, S, input_dim) or (B,
input_dim) are projected to the universal dim (plus, with
``use_moe_projection``, a 4-expert top-2 MoE of the projection), given
learned positions, run through a DeepSeek transformer (MLA + SwiGLU) and
reduced to ``n_tokens`` universal tokens: learned query tokens cross-attend
into the sequence (``n_tokens > 1``), or attention pooling makes one token.
The result is RMSNorm'd.

flax sizes the position table from the first batch it sees; the port builds
its modules before any data, so the caller gives the modality's native
sequence length (``native_seq_len``, 1 for (B, input_dim) inputs).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs import (DeepSeekBlockConfig, MLAConfig, ModalityConfig,
                       MoEConfig, TransformerConfig)
from ..ops.attention import dot_product_attention
from ..ops.norms import RMSNorm
from .deepseek import DeepSeekTransformer, MoELayer
from .layers import Dense, Init, LayerNorm
from .transformer import Transformer

MAX_POSITIONS = 4608  # the longest native sequence (V-JEPA2 patches)


def encoder_transformer_config(m: ModalityConfig,
                               universal_dim: int) -> DeepSeekBlockConfig:
    """The encoder stack's config, derived from the modality as the JAX
    package derives it: head dim max(16, D / heads / 2), a nope slice of at
    most 96 and q head dim (nope + rope) of at most 128, v head dim
    min(head dim, 128), kv_lora_rank max(16, D / 4)."""
    d, heads = universal_dim, m.encoder_heads
    head_dim = max(16, d // heads // 2)
    nope = min(head_dim, 96)
    rope = max(8, min(head_dim // 2, 128 - nope))
    rope -= rope % 2  # rotation acts on pairs
    return DeepSeekBlockConfig(
        hidden_dim=d, n_layers=m.encoder_layers, intermediate_size=d * 2,
        mla=MLAConfig(
            hidden_dim=d, n_heads=heads, kv_lora_rank=max(16, d // 4),
            qk_rope_head_dim=rope, qk_nope_head_dim=nope,
            v_head_dim=min(head_dim, 128), use_flash_attention=True,
            sequence_axis=m.encoder_sequence_axis,
            ring_min_seq=m.encoder_ring_min_seq),
        moe=None)


class ModalityEncoder(nn.Module):
    """A-stack per-modality encoder: (B, input_dim) -> (B, output_dim)."""

    def __init__(self, input_dim: int, output_dim: int,
                 encoder_cfg: TransformerConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        H, cd = encoder_cfg.hidden_dim, compute_dtype
        self.input_projection = Dense(input_dim, H, init, cd)
        self.modality_embedding = init.normal((1, 1, H))
        self.transformer = Transformer(encoder_cfg, init, cd)
        self.output_projection = Dense(H, output_dim, init, cd)
        self.norm = LayerNorm(output_dim, 1e-5, init, cd)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, input_dim); mask optional (B,) bool, True = visible."""
        h = self.input_projection(x)[:, None, :]  # (B, 1, H)
        h = h + self.modality_embedding.to(h.dtype)
        key_mask = mask[:, None] if mask is not None else None
        h = self.transformer(h, key_mask, generator)[:, 0]
        return self.norm(self.output_projection(h))


class _CrossAttention(nn.Module):
    """Multi-head cross-attention of ``dim`` wide queries into a context,
    bias-free projections (the JAX package's ``_CrossAttention``)."""

    def __init__(self, dim: int, n_heads: int, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.n_heads = n_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(dim, dim, init, compute_dtype,
                                        use_bias=False))

    def forward(self, queries: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        B, Nq, D = queries.shape
        Nk, H = context.shape[1], self.n_heads
        Dh = D // H
        q = self.q_proj(queries).view(B, Nq, H, Dh).transpose(1, 2)
        k = self.k_proj(context).view(B, Nk, H, Dh).transpose(1, 2)
        v = self.v_proj(context).view(B, Nk, H, Dh).transpose(1, 2)
        out = dot_product_attention(q, k, v, scale=Dh ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, D))


class UniversalTokenEncoder(nn.Module):
    """native embeddings -> (B, n_tokens, universal_dim) universal tokens."""

    def __init__(self, modality: ModalityConfig, universal_dim: int,
                 init: Init, compute_dtype: torch.dtype, *,
                 native_seq_len: int = 1,
                 max_positions: int = MAX_POSITIONS):
        super().__init__()
        m, D = modality, universal_dim
        self.modality = m
        self.compute_dtype = compute_dtype
        self.input_projection = Dense(m.input_dim, D, init, compute_dtype)
        if m.use_moe_projection:
            self.moe_projection = MoELayer(
                MoEConfig(n_routed_experts=4, num_experts_per_tok=2,
                          moe_intermediate_size=D, hidden_dim=D,
                          n_shared_experts=None),
                init, compute_dtype)
        n_pos = min(max_positions, max(native_seq_len, m.n_tokens))
        self.position_embedding = init.normal((n_pos, D))
        self.transformer = DeepSeekTransformer(
            encoder_transformer_config(m, D), init, compute_dtype,
            remat=m.encoder_remat, remat_policy=m.encoder_remat_policy)
        if m.n_tokens > 1:
            self.query_tokens = init.normal((1, m.n_tokens, D))
            self.token_cross_attention = _CrossAttention(
                D, m.encoder_heads, init, compute_dtype)
        else:
            self.pool_query = init.normal((D,))
        self.output_norm = RMSNorm(D, device=init.device)

    def positions(self, S: int) -> torch.Tensor:
        """(S, D) learned positions; past the table's length, the table
        linearly interpolated to S rows."""
        table = self.position_embedding
        n_pos = table.shape[0]
        if S <= n_pos:
            return table[:S]
        idx = torch.linspace(0.0, n_pos - 1.0, S, dtype=torch.float32,
                             device=table.device)
        lo = idx.floor().long()
        hi = (lo + 1).clamp_max(n_pos - 1)
        w = (idx - lo)[:, None]
        return table[lo] * (1 - w) + table[hi] * w

    def forward(self, native: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """native: (B, S, input_dim) or (B, input_dim). Returns
        (B, n_tokens, universal_dim) in the compute dtype. With the
        modality's ``encoder_remat`` the stack's blocks are checkpointed
        (``encoder_remat_policy``)."""
        m, cd = self.modality, self.compute_dtype
        if native.dim() == 2:
            native = native[:, None, :]
        B, S, _ = native.shape
        x = self.input_projection(native.to(cd))
        if m.use_moe_projection:
            x = x + self.moe_projection(x)
        x = x + self.positions(S).to(x.dtype)[None]
        x = self.transformer(x, generator=generator)
        if m.n_tokens > 1:
            queries = self.query_tokens.to(x.dtype).expand(B, m.n_tokens, -1)
            tokens = self.token_cross_attention(queries, x)
        else:
            logits = torch.einsum("bsd,d->bs", x, self.pool_query.to(x.dtype))
            w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            tokens = torch.einsum("bs,bsd->bd", w, x)[:, None, :]
        return self.output_norm(tokens)
