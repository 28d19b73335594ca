"""Masked multimodal reconstruction losses, PyTorch port of
``deepearth_tpu/training/losses.py``.

A weighted sum of masked spatial and temporal MSE, a per-modality loss
(cross-entropy for learned embeddings, MLM cross-entropy for token
sequences, MAE MSE for decoded sequences, pooled MSE otherwise), CLIP-style
contrastive alignment and species-aware supervised contrastive.

Masked-row convention: a loss averages over the rows whose mask is False,
the entries the model had to reconstruct.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import DeepEarthConfig
from .metrics import coordinate_error_meters, time_error_hours

MOE_AUX_TODO = ("the MoE auxiliary loss needs the DeepSeek simulator's "
                "intermediates, which are not ported yet (ROADMAP.md Queue 1, "
                "item 12)")


@dataclass
class LossWeights:
    spatial: float = 1.0
    temporal: float = 1.0
    modality: float = 1.0  # scaled further by ModalityConfig.loss_weight
    contrastive: float = 0.1
    # species-aware supervised contrastive on the fused representation;
    # needs a categorical 'species' modality in the batch
    species_contrastive: float = 0.0
    moe_aux: float = 0.0
    contrastive_temperature: float = 0.07


def _masked_row_mean(per_row: torch.Tensor, masked_rows: torch.Tensor
                     ) -> torch.Tensor:
    """Mean of per_row over the rows where masked_rows is True (hidden)."""
    w = masked_rows.to(per_row.dtype)
    return (per_row * w).sum() / w.sum().clamp_min(1.0)


def _hidden(mask: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Rows the model did not see: ~mask, or every row without a mask."""
    if mask is None:
        return torch.ones(like.shape, dtype=torch.bool, device=like.device)
    return ~mask


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Per-position softmax cross-entropy with integer labels; logits
    (..., C), labels (...)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def clip_contrastive_loss(a: torch.Tensor, b: torch.Tensor,
                          temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE between two (B, D) embedding sets."""
    logits = (_l2_normalize(a) @ _l2_normalize(b).T) / temperature
    labels = torch.arange(a.shape[0], device=a.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def species_contrastive_loss(emb: torch.Tensor, labels: torch.Tensor,
                             temperature: float) -> torch.Tensor:
    """Species-aware supervised contrastive: all same-species pairs are
    positives; an anchor without a positive is left out."""
    z = _l2_normalize(emb)
    sim = (z @ z.T) / temperature
    eye = torch.eye(emb.shape[0], dtype=torch.bool, device=emb.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    logits = sim.masked_fill(eye, -1e30)
    log_prob = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    pos_count = pos.sum(dim=-1)
    per_anchor = torch.where(
        pos_count > 0,
        -(log_prob * pos).sum(dim=-1) / pos_count.clamp_min(1),
        torch.zeros_like(log_prob[:, 0]))
    return per_anchor.sum() / (pos_count > 0).sum().clamp_min(1)


def deepearth_loss(outputs: Dict[str, Any], batch: Dict[str, Any],
                   config: DeepEarthConfig,
                   weights: Optional[LossWeights] = None,
                   intermediates: Optional[Dict[str, Any]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total loss and a dict of metrics (0-dim fp32 tensors).

    Targets come from the unmasked batch; masks say which rows were hidden
    from the model (mask False = hidden = contributes to the loss).
    """
    w = weights or LossWeights()
    recon = outputs["reconstructions"]
    metrics: Dict[str, torch.Tensor] = {}
    xyzt = batch["xyzt"].float()
    rows = xyzt[:, 0]

    per_row = ((recon["spatial"].float() - xyzt[:, :3]) ** 2).mean(dim=-1)
    l_sp = _masked_row_mean(per_row, _hidden(batch.get("spatial_mask"), rows))
    metrics["loss/spatial"] = l_sp
    total = w.spatial * l_sp

    per_row = ((recon["temporal"].float() - xyzt[:, 3:4]) ** 2).mean(dim=-1)
    l_t = _masked_row_mean(per_row, _hidden(batch.get("temporal_mask"), rows))
    metrics["loss/temporal"] = l_t
    total = total + w.temporal * l_t

    # -- per modality ------------------------------------------------------- #
    masks = batch.get("modality_masks", {})
    patch_masks = batch.get("modality_patch_masks", {})
    for name, m in config.modalities.items():
        if name not in recon or name not in batch.get("modalities", {}):
            continue
        target = batch["modalities"][name]
        hidden = _hidden(masks.get(name), rows)
        pred = recon[name].float()
        if m.encoding_type == "token_sequence":
            # MLM: per-token cross-entropy over the hidden positions
            per_tok = _cross_entropy(pred, target)  # (B, S)
            hidden_tok = _hidden(patch_masks.get(name), per_tok)
            w_tok = (hidden_tok | hidden[:, None]).float()
            denom = w_tok.sum().clamp_min(1.0)
            l_m = (per_tok * w_tok).sum() / denom
            acc_tok = (pred.argmax(dim=-1) == target).float()
            metrics[f"acc/{name}"] = (acc_tok * w_tok).sum() / denom
            metrics[f"loss/{name}"] = l_m
            total = total + w.modality * m.loss_weight * l_m
            continue
        if m.encoding_type == "learned_embedding":
            per_row = _cross_entropy(pred, target)
            acc_row = (pred.argmax(dim=-1) == target).float()
            metrics[f"acc/{name}"] = _masked_row_mean(acc_row, hidden)
        elif m.decode_sequence and target.dim() == 3:
            # MAE: per-patch MSE over the hidden patches
            per_patch = ((pred - target.float()) ** 2).mean(dim=-1)  # (B, S)
            hidden_patch = _hidden(patch_masks.get(name), per_patch)
            w_p = (hidden_patch | hidden[:, None]).float()
            l_m = (per_patch * w_p).sum() / w_p.sum().clamp_min(1.0)
            metrics[f"loss/{name}"] = l_m
            total = total + w.modality * m.loss_weight * l_m
            continue
        else:
            t = target.float()
            if t.dim() == 3:  # (B, S, D) native sequence: pooled target
                t = t.mean(dim=1)
            per_row = ((pred - t) ** 2).mean(dim=-1)
        l_m = _masked_row_mean(per_row, hidden)
        metrics[f"loss/{name}"] = l_m
        total = total + w.modality * m.loss_weight * l_m

    # -- contrastive alignment across modalities ---------------------------- #
    if w.contrastive > 0:
        mt = outputs["modality_tokens"]
        pooled = {n: mt[n].mean(dim=1)
                  for n in sorted(config.modalities) if n in mt}
        if "spacetime" in mt:
            pooled["spacetime"] = mt["spacetime"].mean(dim=1)
        keys = sorted(pooled)
        pairs = [(a, b) for i, a in enumerate(keys) for b in keys[i + 1:]]
        if pairs:
            l_c = sum(clip_contrastive_loss(pooled[a], pooled[b],
                                            w.contrastive_temperature)
                      for a, b in pairs) / len(pairs)
            metrics["loss/contrastive"] = l_c
            total = total + w.contrastive * l_c

    # -- species-aware contrastive ------------------------------------------ #
    if (w.species_contrastive > 0
            and "species" in batch.get("modalities", {})
            and "fused_representation" in outputs):
        l_sc = species_contrastive_loss(
            outputs["fused_representation"].float(),
            batch["modalities"]["species"].long(), w.contrastive_temperature)
        metrics["loss/species_contrastive"] = l_sc
        total = total + w.species_contrastive * l_sc

    if w.moe_aux > 0 and intermediates:
        raise NotImplementedError(MOE_AUX_TODO)

    # -- human-unit error metrics ------------------------------------------- #
    if "spatial_span_m" in batch:
        metrics["err/xyz_m"] = coordinate_error_meters(
            recon["spatial"], xyzt[:, :3], batch["spatial_span_m"])
    if "temporal_span_h" in batch:
        metrics["err/t_h"] = time_error_hours(
            recon["temporal"], xyzt[:, 3:4], batch["temporal_span_h"])

    metrics["loss/total"] = total
    return total, metrics
