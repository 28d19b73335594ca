"""Training layer of the PyTorch port: masking, losses, metrics, the fused
AdamW, the train and eval steps with their Trainer, and the named recipes
(the C-stack's steps, the frozen-parameter optimizer)."""

from .losses import (
    LossWeights,
    clip_contrastive_loss,
    deepearth_loss,
    species_contrastive_loss,
)
from .masking import mae_patch_mask, mlm_token_mask, sample_masks
from .metrics import (
    MetricAccumulator,
    coordinate_error_meters,
    format_epoch_line,
    time_error_hours,
)
from .optimizers import FusedAdamW, global_norm, optimizer_state_bytes
from .recipes import (
    create_vision_decoder_finetune_state,
    frozen_optimizer,
    make_autoencoder_step,
    make_bidirectional_step,
)
from .trainer import (
    MultiSteps,
    TrainState,
    Trainer,
    create_optimizer,
    make_eval_step,
    make_train_step,
    partial_load_params,
)

__all__ = [
    "LossWeights", "clip_contrastive_loss", "deepearth_loss",
    "species_contrastive_loss", "mae_patch_mask", "mlm_token_mask",
    "sample_masks", "MetricAccumulator", "coordinate_error_meters",
    "format_epoch_line", "time_error_hours", "FusedAdamW", "global_norm",
    "optimizer_state_bytes", "MultiSteps", "TrainState", "Trainer",
    "create_optimizer", "make_eval_step", "make_train_step",
    "partial_load_params", "create_vision_decoder_finetune_state",
    "frozen_optimizer", "make_autoencoder_step", "make_bidirectional_step",
]
