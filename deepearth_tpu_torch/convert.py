"""Load a flax parameter tree of the JAX package into the PyTorch port.

The port names its submodules after the flax modules, so a flax path maps to
a torch parameter name by joining with dots and renaming the leaf: Dense
``kernel`` -> ``weight`` (transposed from (in, out) to (out, in)), LayerNorm
``scale`` -> ``weight``, Embed ``embedding`` -> ``weight``. Every other leaf
(``tables``, ``cls_token``, ``modality_embed_*``, ...) keeps its name.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _torch_name(flax_path: Tuple[str, ...]) -> str:
    """The port's parameter name for a flax parameter path."""
    *modules, leaf = flax_path
    return ".".join([*modules, _LEAF_NAMES.get(leaf, leaf)])


def load_flax_params(model: nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy a flax param tree (nested dicts of numpy arrays) into ``model``.

    The mapping is total: it raises ``ValueError`` if a flax leaf has no
    torch parameter, if shapes differ, or if a torch parameter is left
    unfilled. Nothing is copied unless every check passes.
    """
    params: Dict[str, nn.Parameter] = dict(model.named_parameters())
    pending: Dict[str, np.ndarray] = {}
    for path, value in _leaves(tree):
        name = _torch_name(path)
        if name not in params or name in pending:
            raise ValueError(f"flax leaf {'/'.join(path)} has no torch "
                             f"parameter {name!r} of its own")
        if path[-1] == "kernel":
            value = value.T
        if tuple(value.shape) != tuple(params[name].shape):
            raise ValueError(
                f"{'/'.join(path)}: flax shape {value.shape} does not match "
                f"torch {name} {tuple(params[name].shape)}")
        # bfloat16 leaves (ml_dtypes) are not numpy floats torch can read
        pending[name] = value if value.dtype.kind == "f" else value.astype(
            np.float32)
    unfilled = set(params) - set(pending)
    if unfilled:
        raise ValueError(f"torch parameters not in the flax tree: "
                         f"{sorted(unfilled)}")
    with torch.no_grad():
        for name, value in pending.items():
            p = params[name]
            p.copy_(torch.tensor(value, dtype=p.dtype, device=p.device))
