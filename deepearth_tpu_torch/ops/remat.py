"""Where activation checkpointing stands, for the code it recomputes.

Two thread-local flags, read by ``models/deepseek.py`` ``remat_wrap`` and by
the modules it wraps:

* :func:`kernel_site` marks the forward of a hand-written kernel's
  ``torch.autograd.Function`` (K1, K3, K4, K5; on the CPU their plain
  versions). The ``dots`` policies save matmul outputs and recompute
  everything else; in JAX a Pallas call is not a dot, so a kernel's output,
  and every op its plain version runs, is recomputed under both policies.
* :func:`recomputing` is set while a checkpointed block runs again in the
  backward, so that state a forward leaves behind (an MoE layer's
  ``aux_loss``, the hook of ``collect_moe_aux_losses``) keeps the forward's
  values.

Both are per thread: on the card autograd recomputes a block in its own
device thread, and the flags are set and read there.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

_local = threading.local()


@contextlib.contextmanager
def kernel_site() -> Iterator[None]:
    """Inside: the forward of a hand-written kernel (or its plain
    version)."""
    _local.kernel_depth = getattr(_local, "kernel_depth", 0) + 1
    try:
        yield
    finally:
        _local.kernel_depth -= 1


def in_kernel_site() -> bool:
    return getattr(_local, "kernel_depth", 0) > 0


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """Inside: a checkpointed block's recompute in the backward."""
    _local.recompute_depth = getattr(_local, "recompute_depth", 0) + 1
    try:
        yield
    finally:
        _local.recompute_depth -= 1


def is_recomputing() -> bool:
    return getattr(_local, "recompute_depth", 0) > 0
