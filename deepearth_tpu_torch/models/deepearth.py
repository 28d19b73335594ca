"""DeepEarthModel, PyTorch port of ``deepearth_tpu/models/deepearth.py`` for
learned-embedding modalities.

Batch schema (torch tensors on the model's device):
    xyzt:               (B, 4) normalized coordinates
    modalities:         {name: (B,) int category ids}
    modality_masks:     {name: (B,) bool} True = visible (False -> mask token)
    spatial_mask:       (B,) bool True = visible
    temporal_mask:      (B,) bool True = visible
    temporal_positions: optional {name: (B, n, 1)}; defaults to the
                        observation's time for every token
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..configs import DeepEarthConfig
from .decoders import ModalityDecoder, SpatiotemporalDecoder
from .fusion import CrossModalFusion
from .grid4d import Grid4DEncoder
from .layers import Dense, Embed, Init

_TODO = {
    "token_sequence": "models/encoders.py (ROADMAP.md Queue 1, Slice 2)",
    "continuous_values": "models/encoders.py (ROADMAP.md Queue 1, Slice 2)",
    "decode_sequence": "TokenSequenceDecoder with models/encoders.py "
                       "(ROADMAP.md Queue 1, Slice 2)",
    "deepseek_block": "the DeepSeek simulator, models/deepseek.py "
                      "(ROADMAP.md Queue 1, Slice 3)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {_TODO[what]}")


class DeepEarthModel(nn.Module):
    """Grid4D spacetime token + learned modality tokens -> fusion ->
    reconstruction decoders.

    Args:
        config: the model configuration.
        generator: every parameter is drawn from it; it must belong to
            ``device``.
        device: where the parameters live.
    """

    def __init__(self, config: DeepEarthConfig, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        cfg = config
        if cfg.fusion.deepseek_block is not None:
            raise _not_ported("deepseek_block")
        for m in cfg.modalities.values():
            if m.encoding_type != "learned_embedding":
                raise _not_ported(m.encoding_type)
            if m.decode_sequence:
                raise _not_ported("decode_sequence")
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
            self.add_module(f"embed_{name}", Embed(m.vocab_size, D, init, cd))
        # learned-embedding modalities give one token each, so no modality
        # gets the binned spatial position tables (square token grids only)
        self.fusion = CrossModalFusion(
            cfg.fusion, ["spacetime"] + self.modality_names, init, cd)
        self.spatial_decoder = SpatiotemporalDecoder(D, 3, init, cd)
        self.temporal_decoder = SpatiotemporalDecoder(D, 1, init, cd)
        for name in self.modality_names:
            m = cfg.modalities[name]
            self.add_module(f"decoder_{name}",
                            ModalityDecoder(D, m.vocab_size, init, cd))

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.config
        xyzt = batch["xyzt"]
        B = xyzt.shape[0]
        modalities = batch.get("modalities", {})
        masks = batch.get("modality_masks", {})
        if batch.get("spatial_positions"):
            raise ValueError("spatial_positions need spatial tables, which "
                             "single-token modalities do not build")

        st_emb = self.grid4d(xyzt, batch.get("spatial_mask"),
                             batch.get("temporal_mask"))
        if cfg.hidden_dim != cfg.fusion.universal_dim:
            st_emb = self.grid4d_projector(st_emb)
        tokens = {"spacetime": st_emb[:, None, :]}
        for name in self.modality_names:
            if name not in modalities:
                continue
            tok = getattr(self, f"embed_{name}")(modalities[name])[:, None, :]
            if name in masks:
                keep = masks[name][:, None, None]
                tok = torch.where(keep, tok, self.mask_token.to(tok.dtype))
            tokens[name] = tok

        # every token inherits the observation's time unless the batch says
        temporal_positions = dict(batch.get("temporal_positions") or {})
        if cfg.fusion.temporal_aware:
            for name, tok in tokens.items():
                temporal_positions.setdefault(
                    name, xyzt[:, None, 3:4].expand(B, tok.shape[1], 1))
        fusion_out = self.fusion(tokens, None, temporal_positions or None)

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

    @torch.inference_mode()
    def extract_features(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Frozen-feature extraction: the fused CLS representation (B, D)."""
        return self(batch)["fused_representation"]
