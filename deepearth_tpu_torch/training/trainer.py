"""Training harness, PyTorch port of ``deepearth_tpu/training/trainer.py``:
the optimizer and its schedules, the train and eval steps, and the
:class:`Trainer` loop with checkpoint rotation.

The train step runs eagerly: sample masks, forward, loss, backward (through
the kernels' backward on a card), then the optimizer's update in place. Randomness comes from an explicit ``torch.Generator`` on the model's
device: the masks first, then the dropout masks of the forward.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import time
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional, Tuple,
                    Union)

import torch
from torch import nn

from ..configs import DeepEarthConfig, OptimizerConfig, config_to_json
from ..data.batches import echo_on_device
from ..models.deepseek import collect_moe_aux_losses
from .losses import LossWeights, deepearth_loss
from .masking import mae_patch_mask, mlm_token_mask, sample_masks
from .metrics import MetricAccumulator, format_epoch_line
from .optimizers import FusedAdamW, Schedule

logger = logging.getLogger("DeepEarth.Trainer")

# --------------------------------------------------------------------------- #
# schedules: optax's, evaluated at a Python int count
# --------------------------------------------------------------------------- #


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count):
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps)
                                       / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup from init_value to
    peak_value, then cosine decay to end_value at decay_steps (which
    includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warmup(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    """optax.cosine_onecycle_schedule: cosine from peak/div_factor up to
    peak at pct_start, then down to peak/(div_factor*final_div_factor)."""
    if transition_steps <= 0:
        raise ValueError("cosine_onecycle_schedule needs positive "
                         "transition_steps")
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    init = peak_value / div_factor
    values = [init, init * div_factor,
              init * div_factor / (div_factor * final_div_factor)]

    def schedule(count):
        if count >= bounds[-1]:
            return values[-1]
        i = 0 if count < bounds[1] else 1
        pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
        start, end = values[i], values[i + 1]
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
    return schedule


class MultiSteps:
    """optax.MultiSteps: keep the running mean of the gradients over
    ``every_k`` calls of :meth:`step`; on every k-th call hand it to the
    inner optimizer as the parameters' gradient, otherwise leave the
    parameters as they are."""

    def __init__(self, inner: FusedAdamW, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in inner.params]

    @property
    def params(self):
        return self.inner.params

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        for p, acc in zip(self.params, self.acc):
            g = torch.zeros_like(acc) if p.grad is None else p.grad
            acc.add_((g - acc) / (self.mini_step + 1))
        if self.mini_step == self.every_k - 1:
            for p, acc in zip(self.params, self.acc):
                p.grad = acc.clone()
            self.inner.step()
            for acc in self.acc:
                acc.zero_()
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.every_k

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "acc": list(self.acc),
                "mini_step": self.mini_step,
                "gradient_step": self.gradient_step}

    def load_state_dict(self, state_dict):
        self.inner.load_state_dict(state_dict["inner"])
        with torch.no_grad():
            for acc, saved in zip(self.acc, state_dict["acc"]):
                acc.copy_(saved)
        self.mini_step = int(state_dict["mini_step"])
        self.gradient_step = int(state_dict["gradient_step"])


Optimizer = Union[FusedAdamW, MultiSteps]


def create_schedule(cfg: OptimizerConfig) -> Union[float, Schedule]:
    if cfg.schedule == "cosine":
        return warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(cfg.total_steps, cfg.warmup_steps + 1))
    if cfg.schedule == "onecycle":
        return cosine_onecycle_schedule(cfg.total_steps, cfg.learning_rate)
    return cfg.learning_rate


def create_optimizer(params: Iterable[torch.Tensor],
                     cfg: OptimizerConfig,
                     layouts: Optional[list] = None,
                     norm_groups: tuple = ()) -> Optimizer:
    """The configured AdamW over ``params``. ``cfg.fused=False`` (optax's
    clip_by_global_norm chained with adamw in the JAX package) is the same
    math and gets the same optimizer. ``layouts`` and ``norm_groups``:
    ``FusedAdamW``'s, for parameters held as blocks of whole leaves."""
    opt = FusedAdamW(
        params, create_schedule(cfg), b1=cfg.b1, b2=cfg.b2,
        weight_decay=cfg.weight_decay, clip_norm=cfg.grad_clip_norm,
        mu_dtype=torch.bfloat16 if cfg.moment_dtype == "bfloat16" else None,
        second_moment=cfg.second_moment, layouts=layouts,
        norm_groups=norm_groups)
    if cfg.grad_accum_steps > 1:
        return MultiSteps(opt, cfg.grad_accum_steps)
    return opt


@dataclass
class TrainState:
    """The model (whose parameters the steps update in place), its
    optimizer, and the number of train steps taken."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


# --------------------------------------------------------------------------- #
# steps
# --------------------------------------------------------------------------- #


def _map_batch(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_batch(fn, v) for k, v in tree.items()}
    return fn(tree)


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _gather_leaves(tree, n_rows: int, group, keys=None):
    """Every tensor leaf of ``tree`` (under ``keys`` at its top, where
    given) whose first dim is ``n_rows``, gathered over ``group`` in rank
    order (``parallel.comm.gather_rows``: differentiable, its backward a
    reduce-scatter); other leaves as they are."""
    from ..parallel.comm import gather_rows

    def one(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                and x.shape[0] == n_rows:
            return gather_rows(x, group)
        return x
    if keys is None:
        return _map_batch(one, tree)
    return {k: (_map_batch(one, v) if k in keys else v)
            for k, v in tree.items()}


# the model outputs deepearth_loss reads
_LOSS_OUTPUTS = ("reconstructions", "modality_tokens", "fused_representation")


def make_train_step(model: nn.Module, config: DeepEarthConfig,
                    loss_weights: Optional[LossWeights] = None,
                    apply_masking: bool = True,
                    microbatch_steps: int = 1, *,
                    rows_group=None,
                    grad_sync: Optional[Callable[[], None]] = None
                    ) -> Callable:
    """The train step ``(state, batch, generator) -> (state, metrics)``:
    sample masks, forward in training mode, loss, backward, update.

    ``metrics`` holds the loss terms and ``grad_norm``, the global norm of
    the gradients before clipping, as 0-dim tensors on the model's device.
    The loss sees the load-balance loss of every MoE layer call of the
    forward (JAX's ``mutable=["intermediates"]``).
    ``microbatch_steps=k`` splits the batch into k equal microbatches (each
    batch leaf whose first axis is the batch), accumulates their gradients
    and averages them, so the update sees the full-batch mean gradient;
    each microbatch draws its own masks.

    ``rows_group``: a process group over which the batch's rows are split
    (``DistributedTrainer``'s 'data' axis): this rank holds its contiguous
    block of each (micro)batch. Masks are then drawn for the whole batch,
    alike on every rank, and sliced; the loss is taken over the model's
    outputs gathered from every rank (the global masked means, the
    contrastive term over the whole batch), and each rank's backward takes
    1/size of it, so the ranks' gradients sum to the global one.
    ``grad_sync`` runs after the backward and before the gradient norm and
    the update (the trainer's all-reduce). ``grad_norm`` is the optimizer's
    (``FusedAdamW.grad_norm``: over the ranks where each holds blocks of the
    leaves), and the update clips with it.
    """
    from ..parallel.comm import group_rank, group_size

    weights = loss_weights or LossWeights()
    n_ranks = group_size(rows_group)
    my_rank = group_rank(rows_group)
    modality_names = tuple(sorted(config.modalities))
    modality_probs = {n: m.mask_prob for n, m in config.modalities.items()}
    k = int(microbatch_steps)

    def mine(tree, n):
        return _map_batch(lambda x: x[my_rank * n:(my_rank + 1) * n], tree)

    def mask_batch(batch, generator):
        n = batch["xyzt"].shape[0]
        # drawn for every rank's rows, then this rank's kept
        masks = mine(sample_masks(generator, n * n_ranks, modality_names,
                                  config.masking, modality_probs), n)
        batch = {**batch, **masks}
        patch_masks = dict(batch.get("modality_patch_masks", {}))
        for name in modality_names:
            if name in patch_masks or name not in batch.get("modalities", {}):
                continue
            x = batch["modalities"][name]
            m = config.modalities[name]
            if m.encoding_type == "token_sequence" and x.dim() == 2:
                patch_masks[name] = mine(mlm_token_mask(
                    generator, n * n_ranks, x.shape[1],
                    config.masking.language_token_mask_prob), n)
            elif m.encoding_type == "continuous_values" and x.dim() == 3:
                patch_masks[name] = mine(mae_patch_mask(
                    generator, n * n_ranks, x.shape[1],
                    config.masking.vision_patch_mask_prob), n)
        if patch_masks:
            batch = {**batch, "modality_patch_masks": patch_masks}
        return batch

    def backward(batch, generator):
        if apply_masking:
            batch = mask_batch(batch, generator)
        with collect_moe_aux_losses(model) as aux:
            out = model(batch, generator=generator)
        if n_ranks > 1:
            n = batch["xyzt"].shape[0]
            out = _gather_leaves(out, n, rows_group, _LOSS_OUTPUTS)
            batch = _gather_leaves(batch, n, rows_group)
        loss, metrics = deepearth_loss(
            out, batch, config, weights,
            {"moe_aux_loss": aux} if aux else None)
        (loss / n_ranks if n_ranks > 1 else loss).backward()
        return {name: v.detach() for name, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: torch.Generator):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if k <= 1:
            metrics = backward(batch, generator)
        else:
            B = batch["xyzt"].shape[0]
            if B % k:
                raise ValueError(f"batch {B} not divisible by "
                                 f"microbatch_steps {k}")
            metrics = {}
            for i in range(k):
                part = _map_batch(
                    lambda x: (x[i * (B // k):(i + 1) * (B // k)]
                               if isinstance(x, torch.Tensor) and x.dim() >= 1
                               and x.shape[0] == B else x), batch)
                for name, v in backward(part, generator).items():
                    metrics[name] = metrics.get(name, 0.0) + v
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(1.0 / k)
            metrics = {name: v / k for name, v in metrics.items()}
        if grad_sync is not None:
            grad_sync()
        opt = state.optimizer
        inner = opt.inner if isinstance(opt, MultiSteps) else opt
        with torch.no_grad():
            metrics["grad_norm"] = inner.grad_norm(
                [p.grad for p in inner.params])
        if isinstance(opt, MultiSteps):  # clips the mean at its k-th step
            opt.step()
        else:
            opt.step(grad_norm=metrics["grad_norm"])
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module, config: DeepEarthConfig,
                   loss_weights: Optional[LossWeights] = None,
                   apply_masking: bool = True) -> Callable:
    """The eval step ``(state, batch, batch_index=0) -> metrics``, in eval
    mode and without gradients. Its masks are deterministic: drawn from a
    generator seeded with ``batch_index``, so every pass hides the same
    entries of a batch and different batches hide different ones."""
    weights = loss_weights or LossWeights()
    modality_names = tuple(sorted(config.modalities))
    modality_probs = {n: m.mask_prob for n, m in config.modalities.items()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any],
                  batch_index: int = 0):
        model.eval()
        if apply_masking and "spatial_mask" not in batch:
            g = torch.Generator(device=_model_device(model))
            g.manual_seed(int(batch_index))
            batch = {**batch, **sample_masks(
                g, batch["xyzt"].shape[0], modality_names, config.masking,
                modality_probs)}
        _, metrics = deepearth_loss(model(batch), batch, config, weights)
        return metrics

    return eval_step


# --------------------------------------------------------------------------- #
# trainer
# --------------------------------------------------------------------------- #

_CKPT = re.compile(r"step_(\d+)\.pt$")


class Trainer:
    """Host-side training loop with checkpoint rotation: the latest three
    saves are kept, plus the one with the best validation loss.

    Checkpoints are ``torch.save`` files ``step_<n>.pt`` holding the
    model's and the optimizer's state dicts and the step;
    ``best.json`` names the best one, ``config.json`` the config.
    """

    keep = 3

    def __init__(self, model: nn.Module, config: DeepEarthConfig,
                 loss_weights: Optional[LossWeights] = None,
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 microbatch_steps: int = 1):
        self.model = model
        self.config = config
        self.loss_weights = loss_weights or LossWeights()
        self.generator = torch.Generator(device=_model_device(model))
        self.generator.manual_seed(seed)
        self.train_step = make_train_step(model, config, self.loss_weights,
                                          microbatch_steps=microbatch_steps)
        self.eval_step = make_eval_step(model, config, self.loss_weights)
        self.best_val = float("inf")
        self.checkpoint_dir = checkpoint_dir
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            config_to_json(config, os.path.join(checkpoint_dir, "config.json"))

    # -- state --------------------------------------------------------------- #

    def init_state(self) -> TrainState:
        return TrainState(self.model, create_optimizer(
            self.model.parameters(), self.config.optimizer))

    def _path(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir, f"step_{step:08d}.pt")

    def saved_steps(self):
        if not self.checkpoint_dir:
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.checkpoint_dir)
                      if (m := _CKPT.match(f)))

    def best_step(self) -> Optional[int]:
        path = os.path.join(self.checkpoint_dir, "best.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)["step"]

    def save(self, state: TrainState, step: int,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Save ``state`` as ``step``; with ``metrics={'val_loss': x}`` it
        becomes the best checkpoint. Then drop all but the latest three and
        the best."""
        if not self.checkpoint_dir or step in self.saved_steps():
            return
        tmp = self._path(step) + ".tmp"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step}, tmp)
        os.replace(tmp, self._path(step))
        if metrics and "val_loss" in metrics:
            with open(os.path.join(self.checkpoint_dir, "best.json"), "w") as f:
                json.dump({"step": step, "val_loss": metrics["val_loss"]}, f)
        best = self.best_step()
        for s in self.saved_steps()[:-self.keep]:
            if s != best:
                os.remove(self._path(s))

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load the latest (or the given) checkpoint into ``state``."""
        if not self.checkpoint_dir:
            raise ValueError("no checkpoint_dir configured")
        step = step if step is not None else self.saved_steps()[-1]
        ckpt = torch.load(self._path(step), map_location=_model_device(
            state.model), weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state

    # -- loops --------------------------------------------------------------- #

    def fit(self, state: TrainState, train_batches: Iterable[Dict[str, Any]],
            num_steps: int,
            eval_batches: Optional[Callable[[], Iterable[Dict]]] = None,
            eval_every: int = 0, log_every: int = 50, save_every: int = 0,
            metric_sink=None, echo_factor: int = 1
            ) -> Tuple[TrainState, Dict[str, float]]:
        """Run ``num_steps`` train steps. ``metric_sink``: optional object
        with ``log(metrics, step=)``. Every ``eval_every`` steps a better
        validation loss saves a checkpoint; every ``save_every`` steps one
        is saved anyway.

        ``echo_factor``: run each batch through this many optimizer steps
        (data echoing; each step draws fresh masks from the trainer's
        generator). Use when the host -> device link, not the card, bounds
        throughput; pair with device-side batches (``device_prefetch``) so
        repeats are free (see ``data.batches.echo_on_device``)."""
        acc = MetricAccumulator()
        it = iter(train_batches)
        if echo_factor > 1:
            it = echo_on_device(it, echo_factor)
        t0 = time.time()
        last_metrics: Dict[str, float] = {}
        for step in range(1, num_steps + 1):
            batch = next(it)
            state, metrics = self.train_step(state, batch, self.generator)
            acc.update(metrics)
            if log_every and step % log_every == 0:
                last_metrics = acc.result()
                rate = log_every * batch["xyzt"].shape[0] / (time.time() - t0)
                logger.info(format_epoch_line(step, last_metrics,
                                              {"obs/s": rate}))
                if metric_sink is not None:
                    metric_sink.log({**last_metrics, "obs_per_s": rate},
                                    step=step)
                acc.reset()
                t0 = time.time()
            if (eval_every and eval_batches is not None
                    and step % eval_every == 0):
                val = self.evaluate(state, eval_batches())
                val_loss = val.get("loss/total", float("inf"))
                if val_loss < self.best_val:
                    self.best_val = val_loss
                    self.save(state, step, metrics={"val_loss": val_loss})
            if save_every and step % save_every == 0:
                self.save(state, step)
        return state, (last_metrics or acc.result())

    def evaluate(self, state: TrainState,
                 batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        acc = MetricAccumulator()
        for i, batch in enumerate(batches):
            acc.update(self.eval_step(state, batch, i))
        return acc.result()


def partial_load_params(init_params: Mapping[str, torch.Tensor],
                        loaded_params: Mapping[str, torch.Tensor]):
    """Shape-matching partial load for model extension, on state dicts:
    entries whose name is in both and whose shapes match come from
    ``loaded_params``; every other entry keeps its value from
    ``init_params``. Returns (merged, n_loaded, n_skipped), where skipped
    counts names present in both with different shapes."""
    merged = {}
    n_loaded = n_skipped = 0
    for name, v in init_params.items():
        lv = loaded_params.get(name)
        if lv is not None and tuple(lv.shape) == tuple(v.shape):
            merged[name] = lv
            n_loaded += 1
        else:
            merged[name] = v
            if lv is not None:
                n_skipped += 1
    return merged, n_loaded, n_skipped
