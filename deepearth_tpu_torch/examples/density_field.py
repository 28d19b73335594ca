"""Grid4D + MLP density-field regression on the PyTorch port, the
counterpart of ``examples/density_field.py`` (BASELINE.json config #2:
"Grid4D spacetime encoder + MLP decoder only: species-occurrence density
regression over (x,y,z,t) grid").

Trains the hash-grid encoder to regress a synthetic species-occurrence
density over space-time, then evaluates on a dense grid: the NeRF-style
field-query workload. On the card each step runs K2-fwd once (the Grid4D
encode) and K2-bwd once a table.

    python -m deepearth_tpu_torch.examples.density_field [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Grid4DConfig
from ..models.grid4d import Grid4DEncoder
from ..models.layers import Dense, Init
from ..training import Adam

STEPS, BATCH, LR = 300, 4096, 3e-3
SEED = 0


def true_density(xyzt: torch.Tensor) -> torch.Tensor:
    """Synthetic ground-truth density: localized blooms drifting over
    time, (N, 1)."""
    x, y, t = xyzt[:, 0], xyzt[:, 1], xyzt[:, 3]
    cx = 0.3 + 0.3 * t
    cy = 0.6 - 0.2 * t
    d1 = torch.exp(-((x - cx) ** 2 + (y - cy) ** 2) / 0.02)
    d2 = torch.exp(-((x - 0.75) ** 2 + (y - 0.25) ** 2) / 0.01) * (1 - t)
    return (d1 + d2)[:, None]


class DensityField(nn.Module):
    """Grid4D (12 + 6 levels on 2^16 tables) to 64, then Dense 64, gelu
    (flax's tanh form), Dense 1, softplus; fp32. Its submodules carry the
    flax names, so ``convert.load_flax_params`` fills it from the JAX
    example's tree."""

    def __init__(self, generator: torch.Generator, device="cuda"):
        super().__init__()
        init = Init(generator, device)
        self.grid4d = Grid4DEncoder(
            Grid4DConfig(n_spatial_levels=12, n_temporal_levels=6,
                         hash_table_size=2 ** 16),
            64, init, torch.float32)
        self.Dense_0 = Dense(64, 64, init, torch.float32)
        self.Dense_1 = Dense(64, 1, init, torch.float32)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.Dense_0(self.grid4d(xyzt)), approximate="tanh")
        return F.softplus(self.Dense_1(h))


def train_step(model: DensityField, tx: Adam, opt_state, xyzt):
    """One Adam step on the mean squared error against
    :func:`true_density`; returns the loss (before the step) and the
    optimizer state."""
    params = tuple(model.parameters())
    loss = torch.mean((model(xyzt) - true_density(xyzt)) ** 2)
    grads = torch.autograd.grad(loss, params)
    updates, opt_state = tx.update(grads, opt_state)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
    return loss.detach(), opt_state


def eval_grid(device) -> torch.Tensor:
    """The dense 64 x 64 grid at z = 0.1, t = 0.5, x fastest."""
    g = torch.linspace(0, 1, 64, device=device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    n = 64 * 64
    return torch.stack([gx.ravel(), gy.ravel(),
                        torch.full((n,), 0.1, device=device),
                        torch.full((n,), 0.5, device=device)], dim=-1)


def main(device="cuda", steps: int = STEPS) -> dict:
    """Train the field for ``steps`` steps of B=4096 points drawn from a
    generator seeded with 0 on ``device`` (the card unless the
    caller asks for the CPU), then score it on the dense grid: the
    correlation with the truth must pass 0.9. Returns the final loss,
    rmse and correlation."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the example runs on the card by "
                           "default; pass device='cpu' (--device cpu)")
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = DensityField(gen, device)
    tx = Adam(LR)
    opt_state = tx.init(tuple(model.parameters()))
    t0 = time.time()
    for i in range(steps):
        xyzt = torch.rand((BATCH, 4), generator=gen, device=device)
        loss, opt_state = train_step(model, tx, opt_state, xyzt)
        if i % 100 == 0:
            print(f"step {i:4d}  loss {float(loss):.5f}")
    print(f"trained in {time.time() - t0:.1f}s, final loss {float(loss):.5f}")

    grid = eval_grid(device)
    with torch.no_grad():
        pred = model(grid)
    truth = true_density(grid)
    rmse = float(torch.sqrt(torch.mean((pred - truth) ** 2)))
    corr = float(torch.corrcoef(torch.stack([pred.ravel(),
                                             truth.ravel()]))[0, 1])
    print(f"dense-grid eval: rmse={rmse:.4f}  corr={corr:.3f}")
    assert corr > 0.9, "field regression failed to fit"
    print("density field example passed ✓")
    return {"loss": float(loss), "rmse": rmse, "corr": corr}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    main(device=args.device, steps=args.steps)
