"""Named training recipes, PyTorch port of
``deepearth_tpu/training/recipes.py``: the bidirectional reconstruction
step, the multimodal autoencoder's step (reconstruction, species classifier
and species-aware contrastive), and the vision-decoder finetune that freezes
all but the language -> vision decoder.

Each step is ``step(state, batch, generator) -> (state, metrics)`` over a
:class:`TrainState`: forward in training mode, backward, then the
optimizer's update in place. Freezing keeps the frozen parameters out of the
optimizer, as JAX's ``optax.multi_transform`` sends them to
``set_to_zero``: the global norm that clips the update is the trainable
parameters' alone, and a frozen parameter gets no update and no weight
decay.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import OptimizerConfig
from ..convert import _flax_leaves_of
from .losses import species_contrastive_loss
from .trainer import Optimizer, TrainState, create_optimizer


def frozen_optimizer(cfg: OptimizerConfig, model: nn.Module,
                     trainable_predicate: Callable[[str], bool]
                     ) -> Optimizer:
    """The configured optimizer over the parameters whose flax path (its
    names joined by '/', as JAX flattens the param tree:
    ``language_to_vision_full/cond_proj/kernel``) passes the predicate; the
    others are frozen (``requires_grad=False`` in effect: the optimizer
    never sees them)."""
    params = dict(model.named_parameters())
    trainable = [params[name] for name, (path, _) in
                 _flax_leaves_of(model).items()
                 if trainable_predicate("/".join(path))]
    if not trainable:
        raise ValueError("no parameter passes the trainable predicate")
    return create_optimizer(trainable, cfg)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def _step(model: nn.Module, loss_fn: Callable) -> Callable:
    """A train step around ``loss_fn(batch, generator) -> (loss,
    metrics)``: every gradient cleared, the loss's backward, the update."""

    def step(state: TrainState, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None):
        model.train()
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, generator)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}
    return step


def make_bidirectional_step(model: nn.Module) -> Callable:
    """vision <-> language cross-reconstruction step of a
    ``BidirectionalReconstructor``. batch: {'vision': (B, S, Dv) or (B, Dv),
    'language': (B, Dl)}; the MSE of each direction, summed. The vision
    target is the pooled patches where the model decodes pooled vision, and
    the (B, S, Dv) patches laid out as the (B, T, H, W, Dv) grid where it
    decodes the grid (S = T H W). The JAX recipe compares the grid with the
    unreshaped patches, which does not broadcast: there it cannot train
    ``full_vision_output``."""

    def loss_fn(batch, generator):
        out = model(vision=batch["vision"], language=batch["language"])
        recon, v_target = out["vision_from_language"], batch["vision"]
        if v_target.dim() == 3 and recon.dim() == 2:
            v_target = v_target.float().mean(dim=1)
        elif v_target.dim() == 3 and recon.dim() == 5:
            v_target = v_target.reshape(recon.shape)
        l_v = _mse(recon, v_target)
        l_l = _mse(out["language_from_vision"], batch["language"])
        total = l_v + l_l
        return total, {"loss/vision_from_language": l_v,
                       "loss/language_from_vision": l_l,
                       "loss/total": total}
    return _step(model, loss_fn)


def make_autoencoder_step(model: nn.Module, contrastive_weight: float = 0.1,
                          classifier_weight: float = 1.0,
                          temperature: float = 0.07) -> Callable:
    """The ``MultimodalAutoencoder``'s step: vision and language
    reconstruction MSEs, the species classifier's cross-entropy and the
    species-aware contrastive loss of the bottleneck. batch: {'vision',
    'language', 'species' (B,) ints}."""

    def loss_fn(batch, generator):
        out = model(batch["vision"], batch["language"])
        v = batch["vision"].float()
        if v.dim() == 3:
            v = v.mean(dim=1)
        species = batch["species"].long()
        logits = out["species_logits"].float()
        l_vrec = _mse(out["vision_recon"], v)
        l_lrec = _mse(out["language_recon"], batch["language"])
        l_cls = F.cross_entropy(logits, species)
        l_con = species_contrastive_loss(out["embedding"].float(), species,
                                         temperature)
        total = (l_vrec + l_lrec + classifier_weight * l_cls
                 + contrastive_weight * l_con)
        acc = (logits.argmax(dim=-1) == species).float().mean()
        return total, {"loss/vision_recon": l_vrec,
                       "loss/language_recon": l_lrec,
                       "loss/classifier": l_cls,
                       "loss/contrastive": l_con, "loss/total": total,
                       "acc/species": acc}
    return _step(model, loss_fn)


def create_vision_decoder_finetune_state(
        model: nn.Module, opt_cfg: Optional[OptimizerConfig] = None
) -> TrainState:
    """A train state over ``model`` (a ``BidirectionalReconstructor``, its
    parameters in place) that trains only the language -> vision decoder:
    every path holding ``language_to_vision``."""
    tx = frozen_optimizer(opt_cfg or OptimizerConfig(), model,
                          lambda path: "language_to_vision" in path)
    return TrainState(model, tx)
