"""Hierarchical loggers, the port's copy of
``deepearth_tpu/utils/logging.py`` ``get_logger`` (the JAX package's module
is numpy-only, but importing it imports JAX)."""

from __future__ import annotations

import logging


def get_logger(component: str) -> logging.Logger:
    """The ``DeepEarth.<Component>`` logger."""
    return logging.getLogger(f"DeepEarth.{component}")
