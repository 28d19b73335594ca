"""Cross-modal fusion over universal tokens, PyTorch port of
``deepearth_tpu/models/fusion.py`` for the token-major layout.

A CLS token plus per-modality tokens (with temporal and modality
embeddings) run through pre-norm layers: self-attention in every layer,
cross-attention to the pre-fusion tokens every ``cross_attention_freq``
layers, and a SiLU-gated MLP. With at most ``token_major_max_tokens`` tokens
the stack runs token-major, (N, B, D), and every attention site is
:func:`pairwise_token_attention`. In training mode dropout (``cfg.dropout``)
follows each attention output and the MLP, as in the JAX package; its masks
come from the generator the caller passes to ``forward``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import FusionConfig, TransformerConfig
from ..ops.attention_smallseq import pairwise_token_attention, rope_token_major
from .layers import Dense, Init, LayerNorm, dropout
from .transformer import GatedMLP, KernelParam, MLP

BATCH_MAJOR_TODO = (
    "the batch-major fusion layout (more tokens than token_major_max_tokens) "
    "needs ops/rope.py and ops/attention.py with the K3 kernel, which are not "
    "ported yet (ROADMAP.md Queue 1, ops/rope.py and ops/attention.py)")


class SpatialTemporalEmbedding(nn.Module):
    """Temporal MLP into the upper D/2, binned spatial tables into the lower
    D/2, and a per-modality embedding."""

    def __init__(self, universal_dim: int, modality_names: Sequence[str],
                 init: Init, compute_dtype: torch.dtype, *,
                 max_spatial_resolution: int = 64, spatial: bool = False,
                 temporal: bool = True):
        super().__init__()
        D = universal_dim
        self.compute_dtype = compute_dtype
        self.max_spatial_resolution = max_spatial_resolution
        self.modality_names = tuple(modality_names)
        self.has_spatial = spatial
        if spatial:
            r = max_spatial_resolution
            self.spatial_embed_x = init.normal((r, D // 4))
            self.spatial_embed_y = init.normal((r, D // 4))
        self.has_temporal = temporal
        if temporal:
            self.temporal_fc1 = Dense(1, D // 2, init, compute_dtype)
            self.temporal_fc2 = Dense(D // 2, D // 2, init, compute_dtype)
        for name in self.modality_names:
            self.register_parameter(f"modality_embed_{name}",
                                    init.normal((1, 1, D)))

    def forward(self, tokens: torch.Tensor, modality_name: str,
                spatial_positions: Optional[torch.Tensor] = None,
                temporal_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """tokens (B, N, D); spatial_positions (B, N, 2) in [0, 1];
        temporal_positions (B, N, 1)."""
        D = tokens.shape[-1]
        emb = torch.zeros_like(tokens)
        if spatial_positions is not None:
            if not self.has_spatial:
                raise ValueError("spatial positions given to an embedding "
                                 "built without spatial tables")
            r = self.max_spatial_resolution
            xi = (spatial_positions[..., 0] * r).long().clamp(0, r - 1)
            yi = (spatial_positions[..., 1] * r).long().clamp(0, r - 1)
            sp = torch.cat([self.spatial_embed_x[xi], self.spatial_embed_y[yi]],
                           dim=-1)
            emb[..., : D // 2] += sp.to(emb.dtype)
        if temporal_positions is not None:
            if not self.has_temporal:
                raise ValueError("temporal positions given to an embedding "
                                 "built without the temporal MLP")
            h = self.temporal_fc1(temporal_positions.to(self.compute_dtype))
            h = self.temporal_fc2(F.gelu(h))
            emb[..., D // 2:] += h.to(emb.dtype)
        if modality_name in self.modality_names:
            me = getattr(self, f"modality_embed_{modality_name}")
            emb = emb + me.to(emb.dtype)
        return tokens + emb


class FusionAttention(nn.Module):
    """Self- or cross-attention with rotate-half RoPE, token-major (N, B, D).
    RoPE rotates q and k separately, each over its own positions."""

    def __init__(self, cfg: FusionConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        D = cfg.universal_dim
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.q_proj = KernelParam(D, D, init)
        self.k_proj = KernelParam(D, D, init)
        self.v_proj = KernelParam(D, D, init)
        self.out_proj = KernelParam(D, D, init)

    def forward(self, query: torch.Tensor,
                key_value: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg, cd = self.cfg, self.compute_dtype
        H = cfg.num_heads
        Dh = query.shape[-1] // H
        wq, wk, wv = self.q_proj(), self.k_proj(), self.v_proj()
        if key_value is None:
            qkv = F.linear(query.to(cd), torch.cat([wq, wk, wv]).to(cd))
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q = F.linear(query.to(cd), wq.to(cd))
            kv = F.linear(key_value.to(cd), torch.cat([wk, wv]).to(cd))
            k, v = kv.chunk(2, dim=-1)
        if cfg.use_rotary_embeddings:
            q = rope_token_major(q, H)
            k = rope_token_major(k, H)
        out = pairwise_token_attention(q, k, v, n_heads=H, scale=Dh ** -0.5,
                                       key_mask=key_mask)
        out = F.linear(out, self.out_proj().to(cd))
        return dropout(out, cfg.dropout, self.training, generator)


class FusionLayer(nn.Module):
    """Pre-norm fusion layer (LayerNorm eps ``cfg.layer_norm_eps``)."""

    def __init__(self, cfg: FusionConfig, layer_idx: int, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        D, eps, cd = cfg.universal_dim, cfg.layer_norm_eps, compute_dtype
        self.use_cross_attention = layer_idx % cfg.cross_attention_freq == 0
        self.self_attn_norm = LayerNorm(D, eps, init, cd)
        self.self_attn = FusionAttention(cfg, init, cd)
        if self.use_cross_attention:
            self.cross_attn_norm = LayerNorm(D, eps, init, cd)
            self.cross_attn = FusionAttention(cfg, init, cd)
        self.mlp_norm = LayerNorm(D, eps, init, cd)
        if cfg.use_gated_mlp:
            self.mlp = GatedMLP(D, cfg.mlp_ratio, init, cd, cfg.dropout)
        else:
            tcfg = TransformerConfig(hidden_dim=D, mlp_ratio=cfg.mlp_ratio,
                                     dropout=cfg.dropout)
            self.mlp = MLP(tcfg, init, cd)

    def forward(self, x: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_norm(x), key_mask=key_mask,
                               generator=generator)
        if self.use_cross_attention and encoder_hidden_states is not None:
            x = x + self.cross_attn(self.cross_attn_norm(x),
                                    key_value=encoder_hidden_states,
                                    generator=generator)
        return x + self.mlp(self.mlp_norm(x), generator)


class CrossModalFusion(nn.Module):
    """CLS + embedded modality tokens through ``num_fusion_layers`` layers."""

    def __init__(self, cfg: FusionConfig, modality_names: Sequence[str],
                 init: Init, compute_dtype: torch.dtype, *,
                 spatial: bool = False):
        super().__init__()
        D = cfg.universal_dim
        self.cfg = cfg
        self.modality_names = tuple(modality_names)
        self.compute_dtype = compute_dtype
        self.cls_token = init.normal((1, 1, D))
        self.st_embedding = SpatialTemporalEmbedding(
            D, self.modality_names, init, compute_dtype,
            max_spatial_resolution=cfg.max_spatial_resolution,
            spatial=spatial, temporal=cfg.temporal_aware)
        for i in range(cfg.num_fusion_layers):
            self.add_module(f"layer_{i}", FusionLayer(cfg, i, init,
                                                      compute_dtype))
        self.final_norm = LayerNorm(D, cfg.layer_norm_eps, init, compute_dtype)

    def forward(self, modality_tokens: Dict[str, torch.Tensor],
                spatial_positions: Optional[Dict[str, torch.Tensor]] = None,
                temporal_positions: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
        """modality_tokens: {name: (B, n, D)}; generator: dropout masks in
        training mode. Returns the fused CLS token (B, D), all tokens
        (B, N, D) and each modality's tokens."""
        cfg, cd = self.cfg, self.compute_dtype
        names = [n for n in self.modality_names if n in modality_tokens]
        B = next(iter(modality_tokens.values())).shape[0]
        D = cfg.universal_dim
        spatial_positions = spatial_positions or {}
        temporal_positions = temporal_positions or {}

        parts = [self.cls_token.to(cd).expand(1, B, D)]  # token-major
        boundaries = {}
        idx = 1
        for name in names:
            tokens = self.st_embedding(
                modality_tokens[name].to(cd), name,
                spatial_positions.get(name), temporal_positions.get(name))
            parts.append(tokens.transpose(0, 1))
            boundaries[name] = (idx, idx + tokens.shape[1])
            idx += tokens.shape[1]
        if idx > cfg.token_major_max_tokens:
            raise NotImplementedError(BATCH_MAJOR_TODO)

        h = torch.cat(parts, dim=0)  # (N, B, D)
        h_inputs = h  # pre-fusion embedded tokens: the cross-attention context
        for i in range(cfg.num_fusion_layers):
            layer = getattr(self, f"layer_{i}")
            ctx = None
            if layer.use_cross_attention:
                ctx = h_inputs if cfg.cross_attention_context == "inputs" else h
            h = layer(h, ctx, generator=generator)
        h = self.final_norm(h).transpose(0, 1)  # (B, N, D)

        return {
            "fused_representation": h[:, 0],
            "all_tokens": h,
            "modality_tokens": {n: h[:, s:e] for n, (s, e) in boundaries.items()},
        }
