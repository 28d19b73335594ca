"""Device mesh and sharding rules, PyTorch port of
``deepearth_tpu/parallel/mesh.py``.

A :class:`Mesh` names the axes of a grid of ranks, ``(data, expert, model)``
by default. Over initialised ``torch.distributed`` ranks it wraps a
``DeviceMesh`` with those dim names (one process group per axis); without
them it is an abstract shape that the rules read.

The rules are the JAX package's, as pure functions of (path, shape, mesh
shape, fsdp_axes): :func:`param_spec` returns a parameter's
``PartitionSpec`` entries as a tuple (None, an axis name, or a tuple of axis
names a dim is split over). Paths are flax paths, so a port parameter gets
its rule through ``convert.py``'s names, and an optimizer moment reuses its
parameter's rule as in JAX. :func:`make_param_shardings` turns each rule
into DTensor placements on the port's tensor (``Shard(dim)`` /
``Replicate()`` per mesh dim, on the port's dim order: a Dense kernel is
stored transposed). Where a dim is split over several axes, DTensor orders
the shards by mesh dim, so the port keeps that order, not the spec entry's
(the numbers are the same; which rank holds which block differs).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import (Any, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "expert", "model")

Spec = Tuple[Any, ...]


def _factorize(n: int, n_axes: int = 3) -> Tuple[int, ...]:
    """Split n ranks across (data, expert, model), favouring data."""
    if n_axes == 1:
        return (n,)
    shape = [1] * n_axes
    # peel small prime factors onto expert/model first (at most 2 each),
    # give the rest to data
    remaining = n
    for axis in (1, 2):  # expert, model
        if remaining % 2 == 0 and remaining > 2:
            shape[axis] = 2
            remaining //= 2
    shape[0] = remaining
    return tuple(shape)


class Mesh:
    """Named axes over a grid of ranks: ``shape`` maps each axis name to
    its size, in mesh order. ``device_mesh`` is the ``DeviceMesh`` over the
    ranks, or None for an abstract mesh (the rules alone, or one process)."""

    def __init__(self, axis_names: Sequence[str], mesh_shape: Sequence[int],
                 device_mesh=None):
        if len(axis_names) != len(mesh_shape):
            raise ValueError(f"axes {axis_names} vs shape {mesh_shape}")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names,
                                     (int(s) for s in mesh_shape)))
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device_type(self) -> str:
        return (self.device_mesh.device_type if self.device_mesh is not None
                else "cpu")

    def group(self, axis: str):
        """The process group along ``axis`` through this rank (None where
        the mesh is abstract or the axis absent or of size 1)."""
        if (self.device_mesh is None or axis not in self.shape
                or self.shape[axis] == 1):
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on an abstract mesh)."""
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def submesh(self, *axes: str) -> "Mesh":
        """The mesh over ``axes`` through this rank."""
        dm = None
        if self.device_mesh is not None:
            dm = self.device_mesh[axes if len(axes) > 1 else axes[0]]
        return Mesh(axes, [self.shape[a] for a in axes], dm)

    def __repr__(self):
        kind = "abstract" if self.device_mesh is None else self.device_type
        return f"Mesh({dict(self.shape)}, {kind})"


MeshLike = Union[Mesh, Mapping[str, int]]


def _shape_of(mesh: MeshLike) -> Mapping[str, int]:
    return mesh.shape if isinstance(mesh, Mesh) else mesh


def create_mesh(devices: Optional[Sequence[int]] = None,
                mesh_shape: Optional[Tuple[int, ...]] = None,
                axis_names: Tuple[str, ...] = AXES) -> Mesh:
    """A mesh over ``devices`` (the global ranks, all of the world by
    default) with ``axis_names``; ``mesh_shape`` from :func:`_factorize`
    when not given. Over initialised ``torch.distributed`` ranks it builds
    the ``DeviceMesh`` (on the card under NCCL, else the CPU), which every
    rank of the world must call alike; without them, an abstract mesh of
    that shape."""
    initialised = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = list(range(dist.get_world_size() if initialised else 1))
    devices = list(devices)
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = _factorize(n, len(axis_names))
    if int(np.prod(mesh_shape)) != n:
        raise ValueError(f"mesh shape {mesh_shape} != {n} devices")
    if not initialised or (n == 1 and dist.get_world_size() > 1):
        return Mesh(axis_names, mesh_shape)
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type,
                    torch.tensor(devices, dtype=torch.int64).reshape(
                        mesh_shape),
                    mesh_dim_names=tuple(axis_names))
    return Mesh(axis_names, mesh_shape, dm)


def _divisible(dim: int, shape: Mapping[str, int], axis: str) -> bool:
    return axis in shape and dim % shape[axis] == 0


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fsdp_extend(spec: Spec, shape: Tuple[int, ...], mesh: MeshLike,
                 fsdp_axes: Tuple[str, ...]) -> Spec:
    """ZeRO-3/FSDP storage sharding: each requested axis goes on the
    largest dim still divisible, on top of the base rules. Axes the base
    spec uses are never repeated; dims that do not divide are skipped."""
    ms = _shape_of(mesh)
    used = {nm for entry in spec for nm in _names(entry)}
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for ax in fsdp_axes:
        if ax in used or ms.get(ax, 1) == 1:
            continue
        best, best_len = -1, 0
        for i, d in enumerate(shape):
            factor = math.prod(ms[nm] for nm in _names(entries[i]))
            if d % (factor * ms[ax]) == 0 and d // factor > best_len:
                best, best_len = i, d // factor
        if best >= 0:
            names = _names(entries[best]) + (ax,)
            # one axis stays a name, as PartitionSpec writes it
            entries[best] = names[0] if len(names) == 1 else names
            used.add(ax)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def param_spec(path: str, shape: Tuple[int, ...], mesh: MeshLike,
               fsdp_axes: Tuple[str, ...] = ()) -> Spec:
    """The sharding rule of one parameter (or moment) at flax ``path``:

    * stacked MoE expert weights (E, D, F) -> ('expert', None, 'model')
      where divisible (expert and tensor parallelism);
    * hash ``tables`` (L, T, F) replicated, and exempt from FSDP (their
      random gathers stay local);
    * 2-D kernels of at least 128 both ways: the larger dim over 'model';
    * ``embedding`` (V, D): D over 'model';
    * a pipelined stack's ``/stages/`` leaf: its leading stage axis over
      'pipe', the rest by the rules above;
    * everything else replicated; ``fsdp_axes`` then storage-shards what
      the rules leave (:func:`_fsdp_extend`).
    """
    spec = _base_param_spec(path, shape, mesh)
    leaf = path.split("/")[-1]
    if fsdp_axes and not (leaf == "tables" and len(shape) == 3):
        spec = _fsdp_extend(spec, shape, mesh, tuple(fsdp_axes))
    return spec


def splits_experts(path: str, shape: Tuple[int, ...],
                   mesh: MeshLike) -> bool:
    """Whether the rules put 'expert' on a stacked MoE weight's expert dim
    (each rank then keeps its own experts; ``fsdp_axes`` never moves
    'expert' off it)."""
    return any("expert" in _names(e)
               for e in _base_param_spec(path, shape, mesh))


def _base_param_spec(path: str, shape: Tuple[int, ...],
                     mesh: MeshLike) -> Spec:
    ms = _shape_of(mesh)
    leaf = path.split("/")[-1]
    if "/stages/" in f"/{path}/" and len(shape) >= 1:
        if _divisible(shape[0], ms, "pipe") and "pipe" in ms:
            inner = _base_param_spec(leaf, shape[1:], ms)
            inner = list(inner) + [None] * (len(shape) - 1 - len(inner))
            return ("pipe", *inner)
        return ()
    if leaf in ("w_gate", "w_up", "w_down") and len(shape) == 3:
        spec = [None, None, None]
        if _divisible(shape[0], ms, "expert"):
            spec[0] = "expert"
        f_axis = 1 if leaf == "w_down" else 2
        if _divisible(shape[f_axis], ms, "model"):
            spec[f_axis] = "model"
        return tuple(spec)
    if leaf == "tables" and len(shape) == 3:
        return ()
    if leaf == "kernel" and len(shape) == 2 and min(shape) >= 128:
        if shape[1] >= shape[0] and _divisible(shape[1], ms, "model"):
            return (None, "model")
        if _divisible(shape[0], ms, "model"):
            return ("model", None)
        return ()
    if leaf == "embedding" and len(shape) == 2:
        if _divisible(shape[1], ms, "model"):
            return (None, "model")
        return ()
    return ()


class Sharding(NamedTuple):
    """A leaf's layout: ``spec`` (the JAX rule, on the flax dims) and
    ``placements`` (one ``Shard(dim)`` / ``Replicate()`` per mesh dim, on
    the port tensor's dims)."""

    mesh: Mesh
    spec: Spec
    placements: tuple

    def local_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of a tensor of ``shape``."""
        return local_slices(self.mesh, self.placements, shape)

    def is_trivial(self, shape: Sequence[int]) -> bool:
        """Whether this rank's block is the whole tensor."""
        return all(s == slice(0, n) for s, n in
                   zip(self.local_slices(shape), shape))


def placements_for(spec: Spec, mesh: Mesh,
                   perm: Optional[Sequence[int]] = None) -> tuple:
    """DTensor placements of ``spec``: for each mesh axis, ``Shard(d)`` on
    the tensor dim ``perm[i]`` of the spec's dim i that names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for ax in mesh.axis_names:
        dim = next((i for i, e in enumerate(spec) if ax in _names(e)), None)
        if dim is None:
            out.append(Replicate())
        else:
            out.append(Shard(dim if perm is None else perm[dim]))
    return tuple(out)


def local_slices(mesh: Mesh, placements: Sequence[Any],
                 shape: Sequence[int]) -> Tuple[slice, ...]:
    """This rank's block under ``placements``: a dim sharded over several
    mesh dims is split major to minor in mesh order, as DTensor does."""
    from torch.distributed.tensor import Shard

    index = [0] * len(shape)
    parts = [1] * len(shape)
    for ax, pl in zip(mesh.axis_names, placements):
        if isinstance(pl, Shard):
            index[pl.dim] = index[pl.dim] * mesh.shape[ax] + \
                mesh.coordinate(ax)
            parts[pl.dim] *= mesh.shape[ax]
    out = []
    for n, i, p in zip(shape, index, parts):
        size = n // p
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def _tree_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _tree_leaves(value, path)
        else:
            yield path, value


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def module_leaf_layouts(model: torch.nn.Module
                        ) -> Dict[str, Tuple[str, Tuple[int, ...],
                                             Tuple[int, ...]]]:
    """Each port parameter name -> (its flax path, its flax shape, the
    permutation taking flax dims to the port's), from ``convert.py``'s
    naming."""
    from ..convert import _flax_leaves_of, flax_perm

    params = dict(model.named_parameters())
    out = {}
    for name, (path, transposed) in _flax_leaves_of(model).items():
        shape = tuple(params[name].shape)
        perm = flax_perm(len(shape), transposed, "stages" in path[:-1])
        flax_shape = tuple(shape[perm[i]] for i in range(len(shape)))
        out[name] = ("/".join(path), flax_shape, perm)
    return out


def make_param_shardings(params: Any, mesh: Mesh,
                         fsdp_axes: Tuple[str, ...] = ()) -> Any:
    """The :class:`Sharding` of every leaf.

    ``params`` is either a flax-named tree (nested mappings of arrays or
    tensors; the result is the same tree, placements on the tree's own
    dims; scalars replicated) or a port module (the result maps each
    parameter name to its Sharding, placements on the port's dims)."""
    if isinstance(params, torch.nn.Module):
        out = {}
        for name, (path, shape, perm) in module_leaf_layouts(params).items():
            spec = param_spec(path, shape, mesh, fsdp_axes) if shape else ()
            out[name] = Sharding(mesh, spec, placements_for(spec, mesh, perm))
        return out
    tree: Dict[str, Any] = {}
    for path, leaf in _tree_leaves(params):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = (param_spec("/".join(path), shape, mesh, fsdp_axes)
                if shape else ())
        _set_path(tree, path, Sharding(mesh, spec,
                                       placements_for(spec, mesh)))
    return tree


def distribute(full: torch.Tensor, sharding: Sharding):
    """This rank's block of ``full`` as a DTensor under ``sharding`` (a
    plain tensor on an abstract mesh). The block is a view of ``full``
    where the block is all of it."""
    local = full[sharding.local_slices(full.shape)]
    if sharding.mesh.device_mesh is None:
        return local
    if not sharding.is_trivial(full.shape):
        local = local.contiguous().clone()
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, sharding.mesh.device_mesh,
                              sharding.placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def shard_params(params: Any, mesh: Mesh,
                 fsdp_axes: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Each leaf's block for this rank (DTensors over a device mesh): a
    port module's parameters by name, or a flax-named tree's leaves by
    their '/'-joined path."""
    if isinstance(params, torch.nn.Module):
        shardings = make_param_shardings(params, mesh, fsdp_axes)
        return {name: distribute(p.detach(), shardings[name])
                for name, p in params.named_parameters()}
    out = {}
    for path, leaf in _tree_leaves(params):
        t = torch.as_tensor(np.asarray(leaf))
        spec = (param_spec("/".join(path), tuple(t.shape), mesh, fsdp_axes)
                if t.dim() else ())
        out["/".join(path)] = distribute(
            t, Sharding(mesh, spec, placements_for(spec, mesh)))
    return out


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading batch dim over 'data'; the rest replicated."""
    spec = ("data",)
    return Sharding(mesh, spec, placements_for(spec, mesh))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (), placements_for((), mesh))


def _device_of(mesh: Mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_rows(x: Any, mesh: Mesh, axis: str = "data"):
    """This rank's contiguous block of rows of ``x`` along ``axis``."""
    n, i = mesh.shape.get(axis, 1), mesh.coordinate(axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide the '{axis}' "
                         f"axis size {n}")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of every leaf of ``batch`` (the leading dim over
    'data', as :func:`batch_sharding` says), as tensors on the mesh's
    device (the card under NCCL)."""
    from ..data.batches import map_leaves

    device = _device_of(mesh)

    def put(x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        if t.dim() == 0:
            return t.to(device)
        return local_rows(t, mesh).to(device)
    return map_leaves(put, batch)


def process_local_batch_indices(n_total: int,
                                process_index: Optional[int] = None,
                                process_count: Optional[int] = None):
    """DistributedSampler equivalent: this process's contiguous share of
    ``range(n_total)``."""
    initialised = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if initialised else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if initialised else 1)
    per = int(math.ceil(n_total / pc))
    start = pi * per
    return np.arange(start, min(start + per, n_total))
