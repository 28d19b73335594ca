"""The ambient mesh and activation-sharding hints, PyTorch port of
``deepearth_tpu/ops/sharding.py``.

:func:`use_mesh` plays the part of ``jax.set_mesh``: inside it the model
reads the mesh (:func:`ambient_mesh`) where the JAX package reads the
abstract mesh: MLA attention runs ring attention over its
``sequence_axis``, a pipelined DeepSeek stack runs its stages over the
mesh's 'pipe' group. ``rows_local=True`` says that each rank holds only its
own rows of the batch (its block along 'data', as ``DistributedTrainer``
splits it); computations that span the batch in JAX's global program (the
MoE dispatch and its load-balance loss, a pipelined stack's microbatches)
then communicate over 'data' (:func:`data_rows_group`).

Where the ambient mesh's 'expert' axis has more than one rank and divides
an MoE layer's expert count, the layer computes only this rank's experts
(:func:`expert_split`), as JAX's layout puts the experts over 'expert'.

:func:`shard_hint` keeps the JAX package's call sites. There it pins a
large activation's layout for GSPMD; here a rank's tensors are its own
blocks already (its data rows, its experts; the matmuls are not split over
'model'), so the hint returns ``x`` unchanged, with a mesh or without.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch

# module-global, not thread-local: autograd runs the backward (and so the
# recompute of a checkpointed block) on another thread
_STACK: List[Tuple[object, bool]] = []


@contextlib.contextmanager
def use_mesh(mesh, rows_local: bool = False) -> Iterator[None]:
    """Make ``mesh`` (a ``parallel.Mesh``, or None for none) the ambient
    mesh inside; ``rows_local``: the batch's rows are split over 'data'."""
    _STACK.append((mesh, bool(rows_local)))
    try:
        yield
    finally:
        _STACK.pop()


def ambient_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _STACK[-1][0] if _STACK else None


def rows_local() -> bool:
    return bool(_STACK) and _STACK[-1][1] and _STACK[-1][0] is not None


def data_rows_group():
    """The 'data' process group while each rank holds its own rows of the
    batch and 'data' has more than one rank; else None."""
    if not rows_local():
        return None
    return ambient_mesh().group("data")


def expert_split(n_experts: int):
    """(the 'expert' process group, this rank's first expert, its expert
    count) while the ambient mesh's 'expert' axis has more than one rank
    and divides ``n_experts``; else None. Raises where the mesh names such
    an axis but has no process group for it."""
    mesh = ambient_mesh()
    if mesh is None:
        return None
    ranks = int(mesh.shape.get("expert", 1))
    if ranks <= 1 or n_experts % ranks:
        return None
    group = mesh.group("expert")
    if group is None:
        raise RuntimeError(f"{mesh} splits the experts over 'expert' "
                           f"({ranks} ranks) but has no process group for "
                           "it: build it with create_mesh over initialised "
                           "ranks")
    per = n_experts // ranks
    return group, mesh.coordinate("expert") * per, per


def shard_hint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` unchanged: a rank's tensor is its local block already (see the
    module docstring); ``axes`` name the layout JAX pins."""
    return x
