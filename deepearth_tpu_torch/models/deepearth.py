"""DeepEarthModel, PyTorch port of ``deepearth_tpu/models/deepearth.py``.

Batch schema (torch tensors on the model's device):
    xyzt:                 (B, 4) normalized coordinates
    modalities:           {name: (B,) int category ids | (B, Din) |
                          (B, S, Din) native features | (B, S) int token
                          ids of a token_sequence modality}
    modality_masks:       {name: (B,) bool} True = visible (False -> mask
                          token)
    modality_patch_masks: {name: (B, S) bool} True = visible patch or token;
                          a hidden patch of a (B, S, Din) input, or the
                          embedding of a hidden token, contributes zeros
    spatial_mask:         (B,) bool True = visible
    temporal_mask:        (B,) bool True = visible
    spatial_positions:    optional {name: (B, n, 2)}; a modality with a
                          square token count n > 1 defaults to a grid
    temporal_positions:   optional {name: (B, n, 1)}; defaults to the
                          observation's time for every token
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..configs import DeepEarthConfig, ModalityConfig
from ..ops.attention import dot_product_attention
from ..ops.sharding import shard_hint
from .decoders import ModalityDecoder, SpatiotemporalDecoder
from .deepseek import DeepSeekTransformer
from .encoders import UniversalTokenEncoder
from .fusion import CrossModalFusion
from .grid4d import Grid4DEncoder
from .layers import Dense, Embed, Init, LayerNorm


def _native_dim(m: ModalityConfig) -> int:
    if m.encoding_type in ("learned_embedding", "token_sequence"):
        return m.vocab_size
    return m.input_dim


def _n_tokens(m: ModalityConfig) -> int:
    """Universal tokens a modality contributes to the fusion stack."""
    return 1 if m.encoding_type == "learned_embedding" else max(1, m.n_tokens)


def _square_side(n: int) -> Optional[int]:
    side = math.isqrt(n)
    return side if n > 1 and side * side == n else None


class TokenSequenceDecoder(nn.Module):
    """Per-position outputs from a modality's fused tokens: ``seq_len``
    learned position queries cross-attend into them (bias-free q, k, v and
    o projections, ``n_heads`` heads), a residual, LayerNorm, then a Dense
    to ``vocab_size``: MLM logits of a token sequence, or (``vocab_size``
    the native feature dim) the full-sequence MAE reconstruction."""

    def __init__(self, seq_len: int, vocab_size: int, dim: int,
                 n_heads: int, init: Init, compute_dtype: torch.dtype):
        super().__init__()
        self.seq_len, self.n_heads = seq_len, n_heads
        self.compute_dtype = compute_dtype
        self.position_queries = init.normal((seq_len, dim))
        for name in ("q", "k", "v", "o"):
            self.add_module(name, Dense(dim, dim, init, compute_dtype,
                                        use_bias=False))
        self.norm = LayerNorm(dim, 1e-6, init, compute_dtype)
        self.vocab_proj = Dense(dim, vocab_size, init, compute_dtype)

    def forward(self, fused_tokens: torch.Tensor) -> torch.Tensor:
        """fused_tokens (B, n_tokens, dim) -> (B, seq_len, vocab_size)."""
        B, n, D = fused_tokens.shape
        S, H = self.seq_len, self.n_heads
        Dh = D // H
        q_in = self.position_queries.to(self.compute_dtype)[None].expand(
            B, S, D)
        kv = fused_tokens.to(self.compute_dtype)
        q = self.q(q_in).view(B, S, H, Dh).transpose(1, 2)
        k = self.k(kv).view(B, n, H, Dh).transpose(1, 2)
        v = self.v(kv).view(B, n, H, Dh).transpose(1, 2)
        out = dot_product_attention(q, k, v, scale=Dh ** -0.5)
        h = q_in + self.o(out.transpose(1, 2).reshape(B, S, D))
        return self.vocab_proj(self.norm(h))


class DeepEarthModel(nn.Module):
    """Grid4D spacetime token + per-modality universal tokens (learned
    embeddings, or universal-token encoders over native features or over a
    token sequence's embeddings) -> fusion -> (with
    ``fusion.deepseek_block``, the DeepSeek MLA/MoE simulator over the fused
    tokens) -> reconstruction decoders (a token sequence's, and a
    decode_sequence modality's, per position).

    Args:
        config: the model configuration.
        generator: every parameter is drawn from it; it must belong to
            ``device``.
        device: where the parameters live: the card unless the caller asks
            for another device (``device="cpu"``).
        native_seq_lens: each continuous modality's native sequence length S
            for (B, S, Din) inputs (1, the default, for (B, Din) inputs), and
            each token_sequence modality's S for its (B, S) ids (required).
            It sizes the encoder's position table, as the first batch does
            in the JAX package (longer inputs interpolate the table), and
            the position queries of a token_sequence modality's decoder and
            of a decode_sequence modality's, which is built where its S is
            given here (the (B, S, Din) inputs it reconstructs whole).
    """

    def __init__(self, config: DeepEarthConfig, *,
                 generator: torch.Generator, device="cuda",
                 native_seq_lens: Optional[Mapping[str, int]] = None):
        super().__init__()
        cfg = config
        native_seq_lens = dict(native_seq_lens or {})
        for name, m in cfg.modalities.items():
            if m.encoding_type == "token_sequence" and \
                    name not in native_seq_lens:
                raise ValueError(
                    f"token_sequence modality {name!r}: give its sequence "
                    "length in native_seq_lens (it sizes the position table "
                    "and the decoder's position queries)")
        self.config = cfg
        cd = cfg.compute_dtype
        D = cfg.fusion.universal_dim
        init = Init(generator, device, cfg.param_dtype)
        self.grid4d = Grid4DEncoder(cfg.grid4d, cfg.hidden_dim, init, cd)
        if cfg.hidden_dim != D:
            self.grid4d_projector = Dense(cfg.hidden_dim, D, init, cd)
        self.mask_token = init.normal((1, 1, D))
        self.modality_names = sorted(cfg.modalities)
        for name in self.modality_names:
            m = cfg.modalities[name]
            if m.encoding_type in ("learned_embedding", "token_sequence"):
                self.add_module(f"embed_{name}",
                                Embed(m.vocab_size, D, init, cd))
            if m.encoding_type == "token_sequence":
                # the encoder runs over the (B, S, D) embeddings
                self.add_module(f"encoder_{name}", UniversalTokenEncoder(
                    dataclasses.replace(m, input_dim=D), D, init, cd,
                    native_seq_len=native_seq_lens[name]))
            elif m.encoding_type != "learned_embedding":
                self.add_module(f"encoder_{name}", UniversalTokenEncoder(
                    m, D, init, cd,
                    native_seq_len=native_seq_lens.get(name, 1)))
        # binned spatial position tables exist when a modality's tokens get
        # the default grid: a square token count above 1
        spatial = cfg.fusion.spatial_aware and any(
            _square_side(_n_tokens(m)) for m in cfg.modalities.values())
        # fusion.remat checkpoints both the fusion layers and the
        # simulator's blocks, as in the JAX package
        remat = dict(remat=cfg.fusion.remat,
                     remat_policy=cfg.fusion.remat_policy)
        self.fusion = CrossModalFusion(
            cfg.fusion, ["spacetime"] + self.modality_names, init, cd,
            spatial=spatial, **remat)
        if cfg.fusion.deepseek_block is not None:
            self.simulator = DeepSeekTransformer(cfg.fusion.deepseek_block,
                                                 init, cd, **remat)
        self.spatial_decoder = SpatiotemporalDecoder(D, 3, init, cd)
        self.temporal_decoder = SpatiotemporalDecoder(D, 1, init, cd)
        for name in self.modality_names:
            m = cfg.modalities[name]
            if m.encoding_type == "token_sequence" or (
                    m.decode_sequence and name in native_seq_lens):
                # MLM logits per token, or the MAE reconstruction per patch
                decoder = TokenSequenceDecoder(
                    native_seq_lens[name], _native_dim(m), D,
                    m.encoder_heads, init, cd)
            else:
                decoder = ModalityDecoder(D, _native_dim(m), init, cd)
            self.add_module(f"decoder_{name}", decoder)

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """In training mode (``model.train()``) the fusion stack applies
        dropout with masks drawn from ``generator``, which lies on the
        model's device; in eval mode the forward is deterministic."""
        cfg = self.config
        xyzt = batch["xyzt"]
        B = xyzt.shape[0]
        modalities = batch.get("modalities", {})
        masks = batch.get("modality_masks", {})
        patch_masks = batch.get("modality_patch_masks", {})

        st_emb = self.grid4d(xyzt, batch.get("spatial_mask"),
                             batch.get("temporal_mask"))
        if cfg.hidden_dim != cfg.fusion.universal_dim:
            st_emb = self.grid4d_projector(st_emb)
        tokens = {"spacetime": st_emb[:, None, :]}
        for name in self.modality_names:
            if name not in modalities:
                continue
            x = modalities[name]
            kind = cfg.modalities[name].encoding_type
            if name in patch_masks and x.dim() == 3:
                # MAE-style patch masking: hidden patches contribute zeros
                x = x * patch_masks[name][..., None].to(x.dtype)
            if kind == "learned_embedding":
                tok = getattr(self, f"embed_{name}")(x)[:, None, :]
            elif kind == "token_sequence":
                # (B, S) ids -> embeddings; MLM-hidden positions are zeroed
                emb = getattr(self, f"embed_{name}")(x)
                if name in patch_masks:
                    emb = emb * patch_masks[name][..., None].to(emb.dtype)
                tok = getattr(self, f"encoder_{name}")(emb, generator)
            else:
                tok = getattr(self, f"encoder_{name}")(x, generator)
            if name in masks:
                keep = masks[name][:, None, None]
                tok = torch.where(keep, tok, self.mask_token.to(tok.dtype))
            tokens[name] = shard_hint(tok, "data")

        # default positions: a square token count above 1 gets a grid of
        # spatial positions, and every token inherits the observation's
        # time; positions in the batch win
        spatial_positions = dict(batch.get("spatial_positions") or {})
        temporal_positions = dict(batch.get("temporal_positions") or {})
        for name, tok in tokens.items():
            n_tok = tok.shape[1]
            side = _square_side(n_tok)
            if (cfg.fusion.spatial_aware and side
                    and name not in spatial_positions):
                g = (torch.arange(side, dtype=torch.float32,
                                  device=xyzt.device) + 0.5) / side
                gy, gx = torch.meshgrid(g, g, indexing="ij")
                grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
                spatial_positions[name] = grid[None].expand(B, n_tok, 2)
            if cfg.fusion.temporal_aware and name not in temporal_positions:
                temporal_positions[name] = xyzt[:, None, 3:4].expand(
                    B, n_tok, 1)
        fusion_out = self.fusion(tokens, spatial_positions or None,
                                 temporal_positions or None,
                                 generator=generator)
        if cfg.fusion.deepseek_block is not None:
            fusion_out = self._simulate(fusion_out, tokens, generator)

        st_fused = fusion_out["modality_tokens"]["spacetime"].mean(dim=1)
        recon = {"spatial": self.spatial_decoder(st_fused),
                 "temporal": self.temporal_decoder(st_fused)}
        for name in self.modality_names:
            if name not in tokens:
                continue
            fused = fusion_out["modality_tokens"][name]
            decoder = getattr(self, f"decoder_{name}")
            m = cfg.modalities[name]
            whole = m.encoding_type == "token_sequence" or (
                m.decode_sequence and modalities[name].dim() == 3)
            if whole != isinstance(decoder, TokenSequenceDecoder):
                raise ValueError(
                    f"decode_sequence modality {name!r}: its sequence "
                    "decoder is built from native_seq_lens for (B, S, Din) "
                    f"inputs, got {tuple(modalities[name].shape)}")
            recon[name] = decoder(fused if whole else fused.mean(dim=1))
        return {
            "reconstructions": recon,
            "fused_representation": fusion_out["fused_representation"],
            "all_tokens": fusion_out["all_tokens"],
            "modality_tokens": fusion_out["modality_tokens"],
            "input_tokens": tokens,
        }

    def _simulate(self, fusion_out, tokens, generator):
        """The simulator over all fused tokens: its output becomes
        ``all_tokens``, its first token the fused representation, and each
        modality's tokens are sliced from it again, from index 1 in the
        order spacetime, then the modalities by name."""
        h = self.simulator(fusion_out["all_tokens"], generator=generator)
        idx, per_modality = 1, {}
        for name in ["spacetime"] + self.modality_names:
            if name in tokens:
                n = tokens[name].shape[1]
                per_modality[name] = h[:, idx:idx + n]
                idx += n
        return {**fusion_out, "all_tokens": h, "fused_representation": h[:, 0],
                "modality_tokens": per_modality}

    def extract_features(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Frozen-feature extraction: the fused CLS representation (B, D),
        always in eval mode (JAX's ``deterministic=True``); the caller's
        mode is restored after."""
        was_training = self.training
        self.eval()
        try:
            with torch.inference_mode():
                return self(batch)["fused_representation"]
        finally:
            self.train(was_training)
