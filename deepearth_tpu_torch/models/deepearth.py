"""DeepEarthModel, PyTorch port of ``deepearth_tpu/models/deepearth.py``.

Batch schema (torch tensors on the model's device):
    xyzt:                 (B, 4) normalized coordinates
    modalities:           {name: (B,) int category ids | (B, Din) |
                          (B, S, Din) native features}
    modality_masks:       {name: (B,) bool} True = visible (False -> mask
                          token)
    modality_patch_masks: {name: (B, S) bool} True = visible patch; a hidden
                          patch of a (B, S, Din) input contributes zeros
    spatial_mask:         (B,) bool True = visible
    temporal_mask:        (B,) bool True = visible
    spatial_positions:    optional {name: (B, n, 2)}; a modality with a
                          square token count n > 1 defaults to a grid
    temporal_positions:   optional {name: (B, n, 1)}; defaults to the
                          observation's time for every token
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..configs import DeepEarthConfig, ModalityConfig
from .decoders import ModalityDecoder, SpatiotemporalDecoder
from .deepseek import DeepSeekTransformer
from .encoders import UniversalTokenEncoder
from .fusion import CrossModalFusion
from .grid4d import Grid4DEncoder
from .layers import Dense, Embed, Init

_TODO = {
    "token_sequence": "models/encoders.py token_sequence inputs "
                      "(ROADMAP.md Queue 1, item 9)",
    "decode_sequence": "TokenSequenceDecoder (ROADMAP.md Queue 1, item 9)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {_TODO[what]}")


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


class DeepEarthModel(nn.Module):
    """Grid4D spacetime token + per-modality universal tokens (learned
    embeddings, or universal-token encoders over native features) -> fusion
    -> (with ``fusion.deepseek_block``, the DeepSeek MLA/MoE simulator over
    the fused tokens) -> reconstruction decoders.

    Args:
        config: the model configuration.
        generator: every parameter is drawn from it; it must belong to
            ``device``.
        device: where the parameters live: the card unless the caller asks
            for another device (``device="cpu"``).
        native_seq_lens: each continuous modality's native sequence length S
            for (B, S, Din) inputs (1, the default, for (B, Din) inputs). It
            sizes the encoder's position table, as the first batch does in
            the JAX package; longer inputs interpolate the table.
    """

    def __init__(self, config: DeepEarthConfig, *,
                 generator: torch.Generator, device="cuda",
                 native_seq_lens: Optional[Mapping[str, int]] = None):
        super().__init__()
        cfg = config
        for m in cfg.modalities.values():
            if m.encoding_type == "token_sequence":
                raise _not_ported("token_sequence")
            if m.decode_sequence:
                raise _not_ported("decode_sequence")
        self.config = cfg
        cd = cfg.compute_dtype
        D = cfg.fusion.universal_dim
        native_seq_lens = dict(native_seq_lens or {})
        init = Init(generator, device, cfg.param_dtype)
        self.grid4d = Grid4DEncoder(cfg.grid4d, cfg.hidden_dim, init, cd)
        if cfg.hidden_dim != D:
            self.grid4d_projector = Dense(cfg.hidden_dim, D, init, cd)
        self.mask_token = init.normal((1, 1, D))
        self.modality_names = sorted(cfg.modalities)
        for name in self.modality_names:
            m = cfg.modalities[name]
            if m.encoding_type == "learned_embedding":
                self.add_module(f"embed_{name}",
                                Embed(m.vocab_size, D, init, cd))
            else:
                self.add_module(f"encoder_{name}", UniversalTokenEncoder(
                    m, D, init, cd,
                    native_seq_len=native_seq_lens.get(name, 1)))
        # binned spatial position tables exist when a modality's tokens get
        # the default grid: a square token count above 1
        spatial = cfg.fusion.spatial_aware and any(
            _square_side(_n_tokens(m)) for m in cfg.modalities.values())
        self.fusion = CrossModalFusion(
            cfg.fusion, ["spacetime"] + self.modality_names, init, cd,
            spatial=spatial)
        if cfg.fusion.deepseek_block is not None:
            self.simulator = DeepSeekTransformer(cfg.fusion.deepseek_block,
                                                 init, cd)
        self.spatial_decoder = SpatiotemporalDecoder(D, 3, init, cd)
        self.temporal_decoder = SpatiotemporalDecoder(D, 1, init, cd)
        for name in self.modality_names:
            self.add_module(f"decoder_{name}", ModalityDecoder(
                D, _native_dim(cfg.modalities[name]), init, cd))

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
            if name in patch_masks and x.dim() == 3:
                # MAE-style patch masking: hidden patches contribute zeros
                x = x * patch_masks[name][..., None].to(x.dtype)
            if cfg.modalities[name].encoding_type == "learned_embedding":
                tok = getattr(self, f"embed_{name}")(x)[:, None, :]
            else:
                tok = getattr(self, f"encoder_{name}")(x, generator)
            if name in masks:
                keep = masks[name][:, None, None]
                tok = torch.where(keep, tok, self.mask_token.to(tok.dtype))
            tokens[name] = tok

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
            if name in tokens:
                pooled = fusion_out["modality_tokens"][name].mean(dim=1)
                recon[name] = getattr(self, f"decoder_{name}")(pooled)
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
