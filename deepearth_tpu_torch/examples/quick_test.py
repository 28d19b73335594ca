"""Canonical minimal forward pass and a short training run on the PyTorch
port, the counterpart of ``examples/quick_test.py`` (reference:
examples/quick_test.py:22).

Exercises every core component at tiny scale: Grid4D hash encoding, a
modality encoder, the fusion transformer and the reconstruction decoders,
then a few training steps on synthetic data to confirm the loss moves.

    python -m deepearth_tpu_torch.examples.quick_test [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import DeepEarthConfig, ModalityConfig, tiny_config
from ..data import (SyntheticConfig, SyntheticEarthDataGenerator,
                    device_prefetch)
from ..models import DeepEarthModel
from ..training import LossWeights, Trainer

STEPS = 60
SEED = 0
LOSS_WEIGHTS = LossWeights(contrastive=0.01)


def example_config(steps: int = STEPS) -> DeepEarthConfig:
    """``tiny_config`` with a 5-wide ``weather`` source and the example's
    optimizer (lr 3e-3, 5 warmup steps over ``steps``)."""
    cfg = tiny_config()
    cfg.add_modality(ModalityConfig(name="weather", input_dim=5, n_tokens=1,
                                    encoder_layers=1, encoder_heads=2))
    cfg.optimizer.learning_rate = 3e-3
    cfg.optimizer.warmup_steps = 5
    cfg.optimizer.total_steps = steps
    return cfg


class _Losses:
    """A ``Trainer.fit`` metric sink keeping each logged total loss."""

    def __init__(self):
        self.losses = []

    def log(self, metrics, step):
        self.losses.append(float(metrics["loss/total"]))


def main(device="cuda", steps: int = STEPS) -> dict:
    """Build the model on ``device`` (the card unless the caller asks for
    the CPU) from a generator seeded with 0, check one forward,
    train ``steps`` steps at B=16 and check that the loss moved. Returns
    the parameter count and the logged losses."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the example runs on the card by "
                           "default; pass device='cpu' (--device cpu)")
    print(f"device: {device}")
    cfg = example_config(steps)
    data = SyntheticEarthDataGenerator(SyntheticConfig())
    modalities = ("species", "weather")
    batch = next(device_prefetch(
        data.batch_iterator(8, modalities=modalities, steps=1),
        device=device))
    model = DeepEarthModel(
        cfg, generator=torch.Generator(device=device).manual_seed(SEED),
        device=device)

    print("\n=== component shapes ===")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"parameters: {n_params / 1e6:.2f}M")
    with torch.no_grad():
        out = model.eval()(batch)
    print(f"fused representation: {tuple(out['fused_representation'].shape)}")
    for k, v in out["reconstructions"].items():
        print(f"reconstruction[{k}]: {tuple(v.shape)}")
    sp = out["reconstructions"]["spatial"].float().cpu().numpy()
    assert 0.0 <= sp.min() and sp.max() <= 1.0, "spatial decode out of [0,1]"

    print("\n=== short training run ===")
    trainer = Trainer(model, cfg, LOSS_WEIGHTS, seed=SEED)
    state = trainer.init_state()
    sink = _Losses()
    log_every = max(1, steps // 3)
    t0 = time.time()
    state, metrics = trainer.fit(
        state, device_prefetch(data.batch_iterator(16, modalities=modalities),
                               device=device),
        num_steps=steps, log_every=log_every, metric_sink=sink)
    loss = metrics["loss/total"]
    print(f"final loss: {loss:.4f}  ({time.time() - t0:.1f}s)")
    losses = sink.losses
    assert np.isfinite(losses).all(), f"non-finite loss: {losses}"
    assert losses[-1] < losses[0], f"the loss did not move down: {losses}"
    print(f"losses every {log_every} steps: "
          f"{[round(x, 4) for x in losses]}")
    print("\nquick test passed ✓")
    return {"n_params": n_params, "losses": losses, "loss": loss}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    main(device=args.device, steps=args.steps)
