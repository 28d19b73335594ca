"""Human-readable metrics and compact logging, PyTorch port of
``deepearth_tpu/training/metrics.py``: coordinate error in metres, time
error in hours, running means and the compact epoch line
``E042 | L:0.1230 S:0.0200 ... | obs/s:1234.5``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


def coordinate_error_meters(pred_norm: torch.Tensor, true_norm: torch.Tensor,
                            span_meters) -> torch.Tensor:
    """Mean Euclidean error in metres between normalized coordinates, given
    the bounding box's span per axis in metres."""
    span = torch.as_tensor(span_meters, dtype=torch.float32,
                           device=pred_norm.device)
    diff = (pred_norm.float() - true_norm.float()) * span
    return torch.linalg.vector_norm(diff, dim=-1).mean()


def time_error_hours(pred_norm: torch.Tensor, true_norm: torch.Tensor,
                     span_hours: float) -> torch.Tensor:
    """Mean absolute time error in hours."""
    return (pred_norm.float() - true_norm.float()).abs().mean() * span_hours


class MetricAccumulator:
    """Running means over a pass. ``update`` keeps the device scalars as
    they are, so it never waits for the card; ``result`` reads them once."""

    def __init__(self):
        self._vals: Dict[str, list] = {}

    def update(self, metrics: Mapping[str, torch.Tensor]) -> None:
        for k, v in metrics.items():
            self._vals.setdefault(k, []).append(v)

    def result(self) -> Dict[str, float]:
        return {k: float(torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                      for v in vs]).mean())
                for k, vs in self._vals.items()}

    def reset(self) -> None:
        self._vals.clear()


def format_epoch_line(epoch: int, metrics: Mapping[str, float],
                      extra: Optional[Mapping[str, float]] = None) -> str:
    """The compact epoch log line."""
    parts = [f"E{epoch:03d}"]
    short = {"loss/total": "L", "loss/spatial": "S", "loss/temporal": "T",
             "loss/contrastive": "C"}
    body = [f"{label}:{metrics[k]:.4f}" for k, label in short.items()
            if k in metrics]
    body += [f"{k.split('/', 1)[1][:4]}:{metrics[k]:.4f}"
             for k in sorted(metrics)
             if k.startswith("loss/") and k not in short]
    parts.append(" ".join(body))
    if extra:
        parts.append(" ".join(f"{k}:{v:.1f}" for k, v in extra.items()))
    return " | ".join(parts)
