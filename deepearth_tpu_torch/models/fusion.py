"""Cross-modal fusion over universal tokens, PyTorch port of
``deepearth_tpu/models/fusion.py``.

A CLS token plus per-modality tokens (with spatial, temporal and modality
embeddings) run through pre-norm layers: self-attention in every layer,
cross-attention to the pre-fusion tokens every ``cross_attention_freq``
layers, and a SiLU-gated MLP. With at most ``token_major_max_tokens`` tokens
the stack runs token-major, (N, B, D), and every attention site is
:func:`pairwise_token_attention`; with more it runs batch-major, (B, N, D),
and every site is :func:`dot_product_attention`. Parameters do not depend
on the layout. In training mode dropout (``cfg.dropout``) follows each
attention output and the MLP, as in the JAX package; its masks come from the
generator the caller passes to ``forward``. With ``remat`` each layer runs
under ``models/deepseek.py`` ``remat_wrap``.

:class:`HierarchicalFusion` stacks fusion levels with a strided convolution
between them and fuses the levels' CLS tokens.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import FusionConfig, TransformerConfig
from ..ops.attention import dot_product_attention
from ..ops.attention_smallseq import pairwise_token_attention, rope_token_major
from ..ops.rope import apply_rope_half, rope_tables
from .deepseek import remat_context_fn, remat_wrap
from .layers import Conv1d, Dense, Init, LayerNorm, dropout
from .transformer import GatedMLP, KernelParam, MLP


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
    """Self- or cross-attention with rotate-half RoPE, token-major (N, B, D)
    or batch-major (B, N, D). RoPE rotates q and k separately, each over its
    own positions."""

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
                generator: Optional[torch.Generator] = None,
                token_major: bool = True) -> torch.Tensor:
        cfg, cd = self.cfg, self.compute_dtype
        H = cfg.num_heads
        D = query.shape[-1]
        Dh = D // H
        wq, wk, wv = self.q_proj(), self.k_proj(), self.v_proj()
        if key_value is None:
            qkv = F.linear(query.to(cd), torch.cat([wq, wk, wv]).to(cd))
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q = F.linear(query.to(cd), wq.to(cd))
            kv = F.linear(key_value.to(cd), torch.cat([wk, wv]).to(cd))
            k, v = kv.chunk(2, dim=-1)
        if token_major:
            if cfg.use_rotary_embeddings:
                q = rope_token_major(q, H)
                k = rope_token_major(k, H)
            out = pairwise_token_attention(q, k, v, n_heads=H,
                                           scale=Dh ** -0.5,
                                           key_mask=key_mask)
        else:
            B, Nq, Nk = q.shape[0], q.shape[1], k.shape[1]
            q, k, v = (x.unflatten(-1, (H, Dh)).transpose(1, 2)
                       for x in (q, k, v))
            if cfg.use_rotary_embeddings:
                cos_q, sin_q = rope_tables(Nq, Dh, device=q.device)
                cos_k, sin_k = rope_tables(Nk, Dh, device=k.device)
                q = apply_rope_half(q, cos_q, sin_q).to(v.dtype)
                k = apply_rope_half(k, cos_k, sin_k).to(v.dtype)
            out = dot_product_attention(q, k, v, scale=Dh ** -0.5,
                                        key_mask=key_mask)
            out = out.transpose(1, 2).reshape(B, Nq, D)
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
                generator: Optional[torch.Generator] = None,
                token_major: bool = True) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_norm(x), key_mask=key_mask,
                               generator=generator, token_major=token_major)
        if self.use_cross_attention and encoder_hidden_states is not None:
            x = x + self.cross_attn(self.cross_attn_norm(x),
                                    key_value=encoder_hidden_states,
                                    generator=generator,
                                    token_major=token_major)
        return x + self.mlp(self.mlp_norm(x), generator)


class CrossModalFusion(nn.Module):
    """CLS + embedded modality tokens through ``num_fusion_layers`` layers;
    with ``remat`` each layer under ``remat_wrap`` with ``remat_policy``
    (plain attributes, read at every forward)."""

    def __init__(self, cfg: FusionConfig, modality_names: Sequence[str],
                 init: Init, compute_dtype: torch.dtype, *,
                 spatial: bool = False, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        D = cfg.universal_dim
        if remat:
            remat_context_fn(remat_policy)  # an unknown name raises here
        self.remat, self.remat_policy = remat, remat_policy
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

        parts = [self.cls_token.to(cd).expand(B, 1, D)]
        boundaries = {}
        idx = 1
        for name in names:
            tokens = self.st_embedding(
                modality_tokens[name].to(cd), name,
                spatial_positions.get(name), temporal_positions.get(name))
            parts.append(tokens)
            boundaries[name] = (idx, idx + tokens.shape[1])
            idx += tokens.shape[1]

        # the layout follows the token count, as in the JAX package
        token_major = idx <= cfg.token_major_max_tokens
        if token_major:
            h = torch.cat([p.transpose(0, 1) for p in parts], dim=0)  # (N,B,D)
        else:
            h = torch.cat(parts, dim=1)  # (B, N, D)
        h_inputs = h  # pre-fusion embedded tokens: the cross-attention context
        for i in range(cfg.num_fusion_layers):
            layer = getattr(self, f"layer_{i}")
            ctx = None
            if layer.use_cross_attention:
                ctx = h_inputs if cfg.cross_attention_context == "inputs" else h
            if self.remat:
                layer = remat_wrap(layer, self.remat_policy)
            h = layer(h, ctx, generator=generator, token_major=token_major)
        h = self.final_norm(h)
        if token_major:
            h = h.transpose(0, 1)  # (B, N, D)

        return {
            "fused_representation": h[:, 0],
            "all_tokens": h,
            "modality_tokens": {n: h[:, s:e] for n, (s, e) in boundaries.items()},
        }


class HierarchicalFusion(nn.Module):
    """A pyramid of ``num_levels`` fusion stacks (``level_{i}``, each a
    :class:`CrossModalFusion` over ``cfg``). Between levels each modality's
    fused tokens pass a convolution of kernel and stride
    ``downscale_factor`` (``down_{level}_{name}``, flax's 'SAME' padding:
    ceil(n / f) tokens) and the positions are taken with stride f; the
    levels' CLS tokens are concatenated and ``final_fusion`` projects them
    to the universal dim. Each level picks its own layout from its token
    count, so the smaller levels may run token-major (K1 on the card)."""

    def __init__(self, cfg: FusionConfig, modality_names: Sequence[str],
                 init: Init, compute_dtype: torch.dtype, *,
                 num_levels: int = 3, downscale_factor: int = 2,
                 spatial: bool = False):
        super().__init__()
        D = cfg.universal_dim
        self.num_levels, self.downscale_factor = num_levels, downscale_factor
        self.modality_names = tuple(modality_names)
        for level in range(num_levels):
            self.add_module(f"level_{level}", CrossModalFusion(
                cfg, self.modality_names, init, compute_dtype,
                spatial=spatial))
            if level < num_levels - 1:
                for name in self.modality_names:
                    self.add_module(f"down_{level}_{name}", Conv1d(
                        D, D, downscale_factor, downscale_factor, init,
                        compute_dtype))
        self.final_fusion = Dense(num_levels * D, D, init, compute_dtype)

    def forward(self, modality_tokens: Dict[str, torch.Tensor],
                spatial_positions: Optional[Dict[str, torch.Tensor]] = None,
                temporal_positions: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
        """Returns the fused representation (B, D), each level's CLS token
        and their concatenation (B, num_levels * D)."""
        f = self.downscale_factor
        level_reps = []
        current, sp, tp = modality_tokens, spatial_positions, \
            temporal_positions
        for level in range(self.num_levels):
            out = getattr(self, f"level_{level}")(current, sp, tp,
                                                  generator=generator)
            level_reps.append(out["fused_representation"])
            if level < self.num_levels - 1:
                current = {name: getattr(self, f"down_{level}_{name}")(tokens)
                           for name, tokens in out["modality_tokens"].items()}
                if sp is not None:
                    sp = {k: v[:, ::f] for k, v in sp.items()}
                if tp is not None:
                    tp = {k: v[:, ::f] for k, v in tp.items()}
        multi_scale = torch.cat(level_reps, dim=-1)
        return {"fused_representation": self.final_fusion(multi_scale),
                "level_representations": level_reps,
                "multi_scale_representation": multi_scale}
