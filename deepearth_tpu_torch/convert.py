"""Carry parameters and optimizer state between the JAX package's flax
trees and the PyTorch port, both ways.

The port names its submodules after the flax modules, so a flax path maps to
a torch parameter name by joining with dots and renaming the leaf: Dense
``kernel`` -> ``weight`` (transposed from (in, out) to (out, in)), LayerNorm
``scale`` -> ``weight``, Embed ``embedding`` -> ``weight``; RMSNorm's
``weight`` is ``weight`` in both. A Conv ``kernel`` (kernel, in, out)
becomes ``weight`` with its axes reversed, (out, in, kernel), as
``numpy.ndarray.T`` reverses them. Every other leaf (``tables``,
``cls_token``, ``modality_embed_*``, ``position_embedding``,
``query_tokens``, ``pool_query``, ``spatial_embed_x``, ...) keeps its name.
So do the leaves of a quantized model (``ops.quant.quantize_decoder_params``
on either side): ``kernel_q`` / ``kernel_q4`` (stored (D, Fp) as in JAX, not
transposed), the ``scale`` beside them, and an MoE layer's ``w_*_q``,
``w_*_q4`` and ``w_*_scale``; their int8 values stay int8.
Nothing here imports JAX: trees are nested mappings of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_QUANT_KERNELS = ("kernel_q", "kernel_q4")


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _torch_name(flax_path: Tuple[str, ...], quant: bool = False) -> str:
    """The port's parameter name for a flax parameter path; a quantized
    Dense keeps its ``scale``."""
    *modules, leaf = flax_path
    if not quant:
        leaf = _LEAF_NAMES.get(leaf, leaf)
    return ".".join([*modules, leaf])


def load_flax_params(model: nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy a flax param tree (nested dicts of numpy arrays) into ``model``.

    The mapping is total: it raises ``ValueError`` if a flax leaf has no
    torch parameter, if shapes differ, or if a torch parameter is left
    unfilled. Nothing is copied unless every check passes.
    """
    params: Dict[str, nn.Parameter] = dict(model.named_parameters())
    pending: Dict[str, np.ndarray] = {}
    for path, value in _leaves(tree):
        siblings = _get(tree, path[:-1])
        name = _torch_name(path, any(k in siblings for k in _QUANT_KERNELS))
        if name not in params or name in pending:
            raise ValueError(f"flax leaf {'/'.join(path)} has no torch "
                             f"parameter {name!r} of its own")
        if path[-1] == "kernel":
            value = value.T
        if tuple(value.shape) != tuple(params[name].shape):
            raise ValueError(
                f"{'/'.join(path)}: flax shape {value.shape} does not match "
                f"torch {name} {tuple(params[name].shape)}")
        # bfloat16 leaves (ml_dtypes) are not numpy floats torch can read;
        # quantized weights stay int8
        pending[name] = value if value.dtype.kind in "fi" else value.astype(
            np.float32)
    unfilled = set(params) - set(pending)
    if unfilled:
        raise ValueError(f"torch parameters not in the flax tree: "
                         f"{sorted(unfilled)}")
    with torch.no_grad():
        for name, value in pending.items():
            p = params[name]
            p.copy_(torch.tensor(value, dtype=p.dtype, device=p.device))


def _flax_leaves_of(model: nn.Module
                    ) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """Each torch parameter name -> (its flax path, whether it is stored
    transposed), from the type of the module that owns it."""
    from .models.layers import Conv1d, Dense, Embed, LayerNorm
    from .models.transformer import KernelParam
    from .ops.norms import RMSNorm

    weight_leaf = {Dense: "kernel", KernelParam: "kernel", Conv1d: "kernel",
                   LayerNorm: "scale", Embed: "embedding", RMSNorm: "weight"}
    out = {}
    for mod_name, mod in model.named_modules():
        modules = tuple(mod_name.split(".")) if mod_name else ()
        for pname, _ in mod.named_parameters(recurse=False):
            leaf = pname
            if pname == "weight":
                if type(mod) not in weight_leaf:
                    raise ValueError(f"no flax name for the weight of a "
                                     f"{type(mod).__name__}")
                leaf = weight_leaf[type(mod)]
            out[".".join(modules + (pname,))] = (modules + (leaf,),
                                                 leaf == "kernel")
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def flax_params_from_model(model: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`load_flax_params`: the model's parameters as a
    flax-named tree of numpy arrays (kernels transposed back to (in, out);
    bf16 parameters as float32)."""
    params = dict(model.named_parameters())
    tree: Dict[str, Any] = {}
    for name, (path, transposed) in _flax_leaves_of(model).items():
        value = _numpy(params[name])
        _set(tree, path, value.T if transposed else value)
    return tree


def load_flax_opt_state(optimizer, model: nn.Module, opt_state) -> None:
    """Copy the JAX package's ``FusedAdamWState`` (``count``, ``mu``, ``nu``;
    trees shaped like the flax params, a factored ``nu`` leaf has ``row``
    and ``col``) into the port's :class:`FusedAdamW` over ``model``'s
    parameters, so that a JAX run resumes in the port.

    A transposed kernel's moments are transposed too; its factored ``row``
    (mean over the flax kernel's last axis) becomes the port's ``nu_col``
    and ``col`` its ``nu_row``.
    """
    params = dict(model.named_parameters())
    leaves = _flax_leaves_of(model)
    if [id(p) for p in optimizer.params] != [id(p) for p in params.values()]:
        raise ValueError("the optimizer must hold the model's parameters in "
                         "the model's order")
    state = {"count": int(np.asarray(opt_state.count)), "state": []}
    for name, p in params.items():
        path, transposed = leaves[name]
        mu = np.array(_get(opt_state.mu, path), np.float32)
        nu = _get(opt_state.nu, path)
        st = {"mu": torch.from_numpy(mu.T if transposed else mu)}
        if hasattr(nu, "row"):
            row = torch.from_numpy(np.array(nu.row, np.float32))
            col = torch.from_numpy(np.array(nu.col, np.float32))
            st["nu_row"], st["nu_col"] = (col, row) if transposed else (row,
                                                                         col)
        else:
            nu = np.array(nu, np.float32)
            st["nu"] = torch.from_numpy(nu.T if transposed else nu)
        state["state"].append(st)
    optimizer.load_state_dict(state)


def gaussian_scene_from_jax(scene, device="cpu"):
    """The JAX package's ``GaussianScene`` (its five fields as arrays) as
    the port's :class:`~deepearth_tpu_torch.reconstruction.GaussianScene`
    of fp32 tensors on ``device``."""
    from .reconstruction.gaussian_splat import GaussianScene

    return GaussianScene(*(torch.tensor(np.asarray(f), dtype=torch.float32,
                                        device=device) for f in scene))


def camera_from_jax(cam, device="cpu"):
    """The JAX package's ``Camera`` as the port's: rotation and translation
    as fp32 tensors on ``device``, the intrinsics and size as they are."""
    from .reconstruction.gaussian_splat import Camera

    return Camera(torch.tensor(np.asarray(cam.rotation), dtype=torch.float32,
                               device=device),
                  torch.tensor(np.asarray(cam.translation),
                               dtype=torch.float32, device=device),
                  cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
