"""Downstream-task evaluation via linear probes on frozen features, PyTorch
port of ``deepearth_tpu/evaluation/probes.py``
(reference: evaluation/downstream_tasks.py:17-371).

The probe trains on the card unless the caller names another device
(``device="cpu"``); its initial weights come from a ``torch.Generator``
seeded with ``seed`` (JAX's key gives other numbers), the holdout split
from ``np.random.default_rng(seed)`` as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..training.optimizers import Adam

Device = Union[str, torch.device]


@dataclass
class ProbeResult:
    task: str
    kind: str  # 'regression' | 'classification'
    metrics: Dict[str, float]


def _device(device: Device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe trains on the card by "
                           "default; pass device='cpu' to train on the CPU")
    return device


def _init_weight(shape, seed: int, device: torch.device) -> torch.Tensor:
    """The probe's initial W: N(0, 1) * 0.01 from a generator seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device) * 0.01


def _train_linear_probe(
    feats: np.ndarray,
    targets: np.ndarray,
    kind: str,
    n_classes: int = 0,
    steps: int = 300,
    lr: float = 1e-2,
    seed: int = 0,
    holdout_frac: float = 0.2,
    device: Device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Fit W, b with adam on a train split of the frozen features; returns
    predictions and targets on the HELD-OUT split (metrics are generalization
    numbers, not training-set fit)."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    n = len(feats)
    perm = rng.permutation(n)
    n_test = max(1, int(round(n * holdout_frac)))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    if len(train_idx) == 0:
        train_idx = test_idx
    test_idx, train_idx = (torch.as_tensor(i, device=device)
                           for i in (test_idx, train_idx))

    x_all = torch.as_tensor(np.asarray(feats), dtype=torch.float32,
                            device=device)
    mu = x_all[train_idx].mean(0)
    sd = x_all[train_idx].std(0, unbiased=False) + 1e-6
    x = (x_all[train_idx] - mu) / sd
    if kind == "classification":
        y_all = torch.as_tensor(np.asarray(targets), dtype=torch.long,
                                device=device)
        out_dim = n_classes
    else:
        y_all = torch.as_tensor(np.asarray(targets), dtype=torch.float32,
                                device=device)
        if y_all.dim() == 1:
            y_all = y_all[:, None]
        out_dim = y_all.shape[-1]
    y = y_all[train_idx]

    params = (_init_weight((x.shape[1], out_dim), seed, device),
              torch.zeros((out_dim,), device=device))
    tx = Adam(lr)
    opt_state = tx.init(params)

    def loss_fn(w, b):
        pred = x @ w + b
        if kind == "classification":
            return F.cross_entropy(pred, y)
        return torch.mean((pred - y) ** 2)

    for _ in range(steps):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(*leaves), leaves)
        updates, opt_state = tx.update(grads, opt_state)
        params = tuple(p + u for p, u in zip(params, updates))
    x_test = (x_all[test_idx] - mu) / sd
    pred = (x_test @ params[0] + params[1]).cpu().numpy()
    return pred, y_all[test_idx].cpu().numpy()


def regression_metrics(pred: np.ndarray, true: np.ndarray) -> Dict[str, float]:
    rmse = float(np.sqrt(np.mean((pred - true) ** 2)))
    ss_res = np.sum((true - pred) ** 2)
    ss_tot = np.sum((true - true.mean(0)) ** 2) + 1e-12
    return {"rmse": rmse, "r2": float(1.0 - ss_res / ss_tot)}


def classification_metrics(logits: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    pred = logits.argmax(-1)
    acc = float((pred == labels).mean())
    # macro F1
    f1s = []
    for c in np.unique(labels):
        tp = np.sum((pred == c) & (labels == c))
        fp = np.sum((pred == c) & (labels != c))
        fn = np.sum((pred != c) & (labels == c))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1s.append(2 * prec * rec / max(prec + rec, 1e-12))
    return {"accuracy": acc, "f1_macro": float(np.mean(f1s))}


class DeepEarthEvaluator:
    """Frozen-feature linear-probe evaluator
    (reference: evaluation/downstream_tasks.py:56-371).

    feature_fn maps a batch dict → (B, D) numpy features (any level: native /
    universal / fused); the probes train on ``device`` (the card unless the
    caller names another).
    """

    def __init__(self, feature_fn: Callable[[Dict], np.ndarray],
                 device: Device = "cuda"):
        self.feature_fn = feature_fn
        self.device = _device(device)

    def extract(self, batches) -> np.ndarray:
        feats = [np.asarray(self.feature_fn(b)) for b in batches]
        return np.concatenate(feats, axis=0)

    def evaluate_regression(
        self, feats: np.ndarray, targets: np.ndarray, task: str = "regression",
        steps: int = 300,
    ) -> ProbeResult:
        pred, true = _train_linear_probe(feats, targets, "regression",
                                         steps=steps, device=self.device)
        return ProbeResult(task, "regression", regression_metrics(pred, true))

    def evaluate_classification(
        self, feats: np.ndarray, labels: np.ndarray, n_classes: int,
        task: str = "classification", steps: int = 300,
    ) -> ProbeResult:
        pred, true = _train_linear_probe(
            feats, labels, "classification", n_classes=n_classes, steps=steps,
            device=self.device,
        )
        return ProbeResult(task, "classification", classification_metrics(pred, true))
