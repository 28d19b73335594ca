"""Hierarchical logging and metric writers: the port's copy of
``deepearth_tpu/utils/logging.py`` (the JAX package's module is numpy-only,
but importing it imports JAX).

``DeepEarth.<Component>`` loggers, and per-step metric streams written as
JSONL and/or TensorBoard scalars.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Mapping


def get_logger(component: str) -> logging.Logger:
    """The ``DeepEarth.<Component>`` logger."""
    return logging.getLogger(f"DeepEarth.{component}")


def setup_logging(level: int = logging.INFO, stream=None) -> None:
    """One stream handler on the ``DeepEarth`` logger (once a process)."""
    root = logging.getLogger("DeepEarth")
    if root.handlers:
        return
    h = logging.StreamHandler(stream or sys.stderr)
    h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    root.addHandler(h)
    root.setLevel(level)


class JSONLMetricWriter:
    """Append-only JSONL metric stream: one ``{"step", "time", ...}`` line a
    call."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorBoardMetricWriter:
    """Thin TensorBoard wrapper; ``torch.utils.tensorboard`` (and with it
    the ``tensorboard`` package) is imported only when one is made."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir)

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        for k, v in metrics.items():
            self._w.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._w.close()


class MultiWriter:
    """Fan one ``log`` out to several writers (``None`` entries dropped)."""

    def __init__(self, *writers):
        self.writers = [w for w in writers if w is not None]

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        for w in self.writers:
            w.log(metrics, step)

    def close(self) -> None:
        for w in self.writers:
            w.close()
