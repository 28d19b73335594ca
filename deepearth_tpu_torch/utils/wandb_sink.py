"""wandb-compatible metric sink, the PyTorch port's copy of
``deepearth_tpu/utils/wandb_sink.py`` (the JAX package's module is plain
Python, but importing it imports JAX).

The reference logs per-step losses and resource metrics to wandb
(reference: train_deepearth.py:21,231, hpc/train_distrbuted.py:453-459,
training/train_deepearth2.py:434). The trainer emits plain
metric dicts; this sink maps them to wandb's run format when the package
is present and degrades to a local JSONL run directory with the same file
layout otherwise (wandb is not in the air-gapped image), so downstream
tooling sees one interface either way.

Usage::

    sink = WandbSink(project="deepearth", config=cfg_dict)
    sink.log({"loss/total": 0.12, "obs_per_s": 153.0}, step=10)
    sink.finish()

or hook it into ``Trainer.fit`` via ``metric_sink=``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping, Optional

from .logging import get_logger

logger = get_logger("WandbSink")


def _wandb():
    try:
        import wandb  # noqa: F401

        return wandb
    except Exception:
        return None


class WandbSink:
    """Per-step metric logger: wandb when available, JSONL otherwise.

    The JSONL fallback writes ``<dir>/wandb-history.jsonl`` (one JSON object
    per log call, with ``_step`` and ``_runtime`` keys — wandb's history
    schema) and ``<dir>/wandb-metadata.json`` (project/config), so local
    runs can later be imported with ``wandb sync``-style tooling.
    """

    def __init__(
        self,
        project: str = "deepearth",
        name: Optional[str] = None,
        config: Optional[Mapping[str, Any]] = None,
        dir: Optional[str] = None,
        mode: str = "auto",  # 'auto' | 'wandb' | 'offline'
    ):
        self._t0 = time.time()
        self._step = 0
        self._run = None
        self._fh = None
        wandb = _wandb() if mode in ("auto", "wandb") else None
        if wandb is not None:
            self._run = wandb.init(
                project=project, name=name, config=dict(config or {}),
                dir=dir,
            )
            self.backend = "wandb"
            return
        if mode == "wandb":
            raise ImportError("wandb requested but not importable")
        out = dir or os.path.join("runs", name or f"run-{int(self._t0)}")
        os.makedirs(out, exist_ok=True)
        self.dir = out
        with open(os.path.join(out, "wandb-metadata.json"), "w") as f:
            json.dump(
                {"project": project, "name": name,
                 "config": _jsonable(dict(config or {})),
                 "start_time": self._t0},
                f, indent=2,
            )
        self._fh = open(os.path.join(out, "wandb-history.jsonl"), "a")
        self.backend = "jsonl"
        logger.info(f"wandb unavailable; logging history to {out}")

    def log(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        step = self._step if step is None else int(step)
        self._step = step + 1
        if self._run is not None:
            self._run.log(dict(metrics), step=step)
            return
        row = {
            "_step": step,
            "_runtime": time.time() - self._t0,
            **_jsonable(dict(metrics)),
        }
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            try:
                out[k] = float(v)
            except Exception:
                out[k] = str(v)
    return out
