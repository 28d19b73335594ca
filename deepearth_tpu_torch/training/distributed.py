"""Multi-process distributed training, PyTorch port of
``deepearth_tpu/training/distributed.py``.

* :func:`initialize_distributed` joins the ranks from the JAX package's
  environment variables (or torchrun's), NCCL on the card, gloo on the CPU.
* :class:`DistributedTrainer` trains over a :class:`~..parallel.Mesh`:
  every parameter and optimizer moment is stored at the block of it that
  JAX's sharding rule gives this rank (DTensor placements from
  ``parallel.mesh``; ``fsdp_axes`` storage-shards what the rules leave
  replicated), the batch's rows are split over 'data', and the step's
  losses and MoE routing see the global batch (``make_train_step``'s
  ``rows_group``), so the numbers are the single-device step's.

How a step runs: as JAX's GSPMD runs its step over the same shardings.
Each parameter stays this rank's block. The model runs in units (each
DeepSeek decoder layer, MoE layer, fusion layer, transformer block and
pipelined stack, and one root unit for the leaves outside them); just
before a unit runs, each of its blocks is all-gathered whole over the
axes that split it (``comm.gather_unit``), and once it has run the whole
copies are freed. A tensor autograd saved from a whole copy does not keep
it: the backward gathers the copy again where it unpacks the tensor
(``comm.saved_whole_hooks``; a checkpointed block's recompute gathers
anew), and frees it once the copy's gradient is complete. Nor does a
tensor made from the copies and the parameters used as they are alone (a
layer's cast of its weights to the compute dtype, a concatenation of
weights): autograd keeps how it was made, and the backward makes it again
from the copies. A whole copy's gradient goes back to the block by the
meaning of each axis: summed over 'data' (its ranks compute different
rows; a reduce-scatter, an all-reduce where the leaf is whole over
'data') and over 'pipe' for a stacked stage's leaf; taken as this rank's
block without a sum over 'expert', 'model' and 'sequence', whose ranks
compute the same rows and so the same gradient.
No rank holds the whole model's weights or gradients at once, in the
parameters' dtype or the compute dtype.

The experts of an MoE layer are split over 'expert': a rank keeps its
E / ranks experts (their rule's block, never gathered over 'expert'),
runs them on every token it routes, and the blocks' outputs are summed
over the axis (``models.deepseek.MoELayer``); an MoE layer on a capacity
route gathers its tokens over 'data' first, so its slots follow the
global token order. Ranks along 'sequence' split attention by ring
(``parallel.ring``) and ranks along 'pipe' run one pipeline stage each
(``parallel.pipeline``); the matmuls are not split over 'model' and a
'pipe' rank gathers every stage's weights for the step.

The fused AdamW update runs on the blocks (``FusedAdamW``'s
``layouts``): the global norm sums each element's square once over the
mesh, a factored second moment's row and column means add the blocks'
partial sums over the ranks that split the reduced dim; its factors are
kept at the block's rows and columns. ``MultiSteps``'s accumulators are
blocks too.

Checkpoints are ``torch.distributed.checkpoint`` directories of the
sharded state, one per step; Orbax's format is JAX's own and the port does
not write it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import re
import shutil
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import DeepEarthConfig
from ..data.batches import map_leaves
from ..ops import remat as remat_sites
from ..ops.sharding import use_mesh
from ..parallel import comm
from ..parallel.mesh import (Mesh, Sharding, create_mesh,
                             module_leaf_layouts, param_spec,
                             placements_for, splits_experts)
from .losses import LossWeights
from .optimizers import BlockLayout
from .trainer import MultiSteps, TrainState, create_optimizer, \
    make_train_step

logger = logging.getLogger("DeepEarth.Distributed")

_STEP_DIR = re.compile(r"step_(\d+)$")
SAVE_THREADS = 8


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda") -> None:
    """``torch.distributed.init_process_group`` from the JAX package's
    variables: ``COORDINATOR_ADDRESS`` (host:port, or an ``init_method``
    URL such as ``file://...``), else ``MASTER_ADDR`` / ``MASTER_PORT``;
    ``NUM_PROCESSES`` else ``WORLD_SIZE``; ``PROCESS_ID`` else ``RANK``.
    Without an address or a count, one process joins alone (an in-memory
    store). NCCL on the card (``device='cuda'``, each rank on card
    ``LOCAL_RANK`` or its rank modulo the card count; raises without a
    card), gloo with ``device='cpu'``. A second call does nothing."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda') needs "
                               "a CUDA device; pass device='cpu' for gloo")
        backend = "nccl"
    else:
        backend = "gloo"
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "COORDINATOR_ADDRESS") or (
        f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '1234')}"
        if "MASTER_ADDR" in env else None)
    num_processes = num_processes or int(
        env.get("NUM_PROCESSES", env.get("WORLD_SIZE", 0))) or None
    if process_id is None:
        process_id = int(env.get("PROCESS_ID", env.get("RANK", -1)))
    process_id = process_id if process_id >= 0 else None
    if coordinator_address is None and num_processes in (None, 1):
        rank, world = 0, 1
        kwargs = dict(store=dist.HashStore())
    else:
        rank, world = process_id or 0, num_processes or 1
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kwargs = dict(init_method=url)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)
    logger.info(f"distributed initialized: rank {rank}/{world}, {backend}")


def _demote_ragged_dispatch(cfg):
    """The ragged grouped-matmul dispatch routes each rank's own tokens and
    has no expert-parallel layout; under an expert axis > 1 every MoE
    config using it becomes 'auto' (with ``allow_ragged`` off, so 'auto'
    does not pick it again). Returns a new config; the caller's stays."""

    def fix(node):
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            changes = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                nv = fix(v)
                if nv is not v:
                    changes[f.name] = nv
            if hasattr(node, "n_routed_experts"):
                if getattr(node, "dispatch_mode", None) == "ragged":
                    changes["dispatch_mode"] = "auto"
                    logger.warning(
                        "ragged MoE dispatch demoted to 'auto' under an "
                        "expert-parallel mesh")
                if getattr(node, "allow_ragged", False):
                    changes["allow_ragged"] = False
            return dataclasses.replace(node, **changes) if changes else node
        if isinstance(node, dict):
            out = {k: fix(v) for k, v in node.items()}
            return out if any(out[k] is not node[k] for k in node) else node
        return node

    return fix(cfg)


class _Leaf:
    """One tensor of the train state: where this rank's block of it lives
    (a parameter's data or an optimizer state entry), its sharding and the
    whole leaf's shape."""

    def __init__(self, key: str, get, sharding: Sharding, shape):
        self.key, self.get = key, get
        self.sharding, self.shape = sharding, tuple(shape)


def _unit_types() -> tuple:
    """The modules that gather their own blocks when they run."""
    from ..models.deepseek import DeepSeekBlock, MoELayer, PipelineStages
    from ..models.fusion import FusionLayer
    from ..models.transformer import TransformerBlock

    return (DeepSeekBlock, MoELayer, PipelineStages, FusionLayer,
            TransformerBlock)


def _factor_sharding(sh: Sharding, dropped: int) -> Sharding:
    """A factored second moment's sharding: its parameter's, the dim the
    mean runs over (``dropped``) held whole (every rank holding a part of it
    computes the same factor) and the dims after it moved down one."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for pl in sh.placements:
        if isinstance(pl, Shard) and pl.dim == dropped:
            out.append(Replicate())
        elif isinstance(pl, Shard) and pl.dim > dropped:
            out.append(Shard(pl.dim - 1))
        else:
            out.append(pl)
    return Sharding(sh.mesh, None, tuple(out))


class DistributedTrainer:
    """Mesh-sharded training: dp x ep x tp x pp x sp over a
    :class:`~..parallel.Mesh` (see the module docstring).

    ``lr_scale_by_data_parallel`` multiplies the learning rate by the
    'data' width, on a copy of the config. ``fsdp_axes`` storage-shards
    the parameters and moments over those axes on top of the rules.
    ``microbatch_steps=k`` accumulates k microbatches in the step
    (``make_train_step``): microbatch i is rows [i B/k, (i+1) B/k) of the
    global batch, as in JAX. ``apply_masking=False`` takes the masks from
    the batch (the port's extension, for runs held against another). Under
    an expert axis > 1 a ragged MoE dispatch is demoted to 'auto', in the
    trainer's config and in the model's MoE layers.

    :meth:`init_state` makes the model the trainer's, once: its
    parameters become this rank's blocks and its units gather them in
    forward hooks, so the model runs only inside :meth:`step` (a forward
    elsewhere raises) and a second ``init_state`` raises. To evaluate or
    export it, :meth:`full_params` gathers the parameters whole into a
    state dict for a model of the same config."""

    keep = 3

    def __init__(self, model: torch.nn.Module, config: DeepEarthConfig,
                 loss_weights: Optional[LossWeights] = None,
                 mesh: Optional[Mesh] = None,
                 lr_scale_by_data_parallel: bool = True, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 fsdp_axes: Tuple[str, ...] = (),
                 microbatch_steps: int = 1, apply_masking: bool = True):
        self.model = model
        self.config = config
        # the port reads ShardingConfig.mesh_shape for the default mesh
        # (JAX's trainer derives it from the devices alone)
        self.mesh = mesh or create_mesh(mesh_shape=(
            tuple(config.sharding.mesh_shape)
            if config.sharding.mesh_shape else None))
        if self.mesh.size > 1 and self.mesh.device_mesh is None:
            raise ValueError(f"{self.mesh} has no ranks: initialise "
                             "torch.distributed (initialize_distributed) "
                             "and build the mesh with create_mesh")
        self.checkpoint_dir = (os.path.abspath(checkpoint_dir)
                               if checkpoint_dir else None)
        self.data_width = int(self.mesh.shape.get("data", 1))
        if lr_scale_by_data_parallel:
            self.config = config = dataclasses.replace(
                config, optimizer=dataclasses.replace(
                    config.optimizer,
                    learning_rate=config.optimizer.learning_rate
                    * self.data_width))
        self.loss_weights = loss_weights or LossWeights()
        self.fsdp_axes = tuple(fsdp_axes)
        self.microbatch_steps = int(microbatch_steps)
        self.apply_masking = apply_masking
        if int(self.mesh.shape.get("expert", 1)) > 1:
            self.config = _demote_ragged_dispatch(self.config)
            from ..models.deepseek import MoELayer, PipelineStages

            layers = [m for m in model.modules() if isinstance(m, MoELayer)]
            for mod in model.modules():  # the stages' blocks, kept apart
                if isinstance(mod, PipelineStages):
                    layers += [m for t in mod._templates
                               for m in t.modules()
                               if isinstance(m, MoELayer)]
            for mod in layers:
                mod.cfg = _demote_ragged_dispatch(mod.cfg)
        device = next(model.parameters()).device
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self._leaves: List[_Leaf] = []
        self._step_fn = None
        self._units: Dict[torch.nn.Module, list] = {}
        self._sync: List[Tuple[torch.nn.Parameter, tuple]] = []
        self._splitting = False
        self._open: List[Tuple[list, comm.UnitGather]] = []
        self.gathered_peak = self.made_peak = 0

    # -- state --------------------------------------------------------------- #

    def _sharding(self, path: str, shape, perm) -> Sharding:
        spec = param_spec(path, shape, self.mesh, self.fsdp_axes) \
            if shape else ()
        return Sharding(self.mesh, spec, placements_for(spec, self.mesh,
                                                        perm))

    def _layout(self, sh: Sharding, whole: Tuple[int, ...]) -> BlockLayout:
        """The optimizer's view of a block: per dim the groups splitting it;
        counted in the global norm by the first rank of each axis that holds
        it whole."""
        from torch.distributed.tensor import Shard

        dim_groups = [[] for _ in whole]
        counted = True
        for ax, pl in zip(self.mesh.axis_names, sh.placements):
            group = self.mesh.group(ax)
            if group is None:
                continue
            if isinstance(pl, Shard):
                dim_groups[pl.dim].append(group)
            elif self.mesh.coordinate(ax):
                counted = False
        return BlockLayout(whole, tuple(tuple(g) for g in dim_groups),
                           counted)

    def _plan(self, path: str, sh: Sharding, whole: Tuple[int, ...],
              experts: bool) -> Tuple[Optional[comm.ParamGather], tuple]:
        """How a parameter's block is gathered for its unit (None: it is
        used as it is) and the groups its gradient is summed over after the
        backward (where it is not gathered). ``experts``: the rules put
        'expert' on the leaf's expert dim (``splits_experts``)."""
        from torch.distributed.tensor import Shard

        stage = "/stages/" in f"/{path}/"
        axes, sums = [], []
        for index, (ax, pl) in enumerate(zip(self.mesh.axis_names,
                                             sh.placements)):
            group = self.mesh.group(ax)
            if group is None:
                continue
            rows = ax == "data" or (ax == "pipe" and stage)
            if not isinstance(pl, Shard):
                if rows:
                    sums.append(group)
                continue
            if ax == "expert" and experts:
                # the rank's own experts: never gathered over 'expert'
                if any(isinstance(p, Shard) and p.dim == pl.dim and a != ax
                       for a, p in zip(self.mesh.axis_names, sh.placements)
                       if self.mesh.group(a) is not None):
                    raise ValueError(f"{path}: its expert dim is split over "
                                     "'expert' and another axis")
                continue
            axes.append(comm.GatherAxis(index, group, pl.dim, rows))
        if not axes:
            return None, tuple(sums)
        shape = [s.stop - s.start for s in sh.local_slices(whole)]
        for ax in axes:
            shape[ax.dim] *= comm.group_size(ax.group)
        return comm.ParamGather(tuple(reversed(axes)), tuple(sums),
                                tuple(shape)), ()

    def init_state(self, sample_batch: Optional[Dict[str, Any]] = None
                   ) -> TrainState:
        """The model's parameters (alike on every rank: the mesh's first
        rank's are broadcast), each then kept as this rank's block, and a
        fresh optimizer over the blocks. ``sample_batch`` is not needed
        (the port's model is built already); it is taken for JAX's call
        shape."""
        if self._leaves:
            raise RuntimeError("init_state ran already: the model's "
                               "parameters are this rank's blocks")
        layouts = module_leaf_layouts(self.model)
        named = dict(self.model.named_parameters())
        info = {}
        with torch.no_grad():
            # the mesh's first rank's parameters, axis by axis
            params = [p.data for p in named.values()]
            for axis in self.mesh.axis_names:
                group = self.mesh.group(axis)
                if group is not None:
                    comm.broadcast_(params, group)
            for name, p in named.items():
                path, shape, perm = layouts[name]
                sh = self._sharding(path, shape, perm)
                whole = tuple(p.shape)
                if not sh.is_trivial(whole):
                    p.data = p.data[sh.local_slices(whole)].clone()
                info[name] = (path, sh, whole,
                              splits_experts(path, shape, self.mesh))
        norm_groups = tuple(g for g in map(self.mesh.group,
                                           self.mesh.axis_names)
                            if g is not None)
        state = TrainState(self.model, create_optimizer(
            self.model.parameters(), self.config.optimizer,
            layouts=[self._layout(info[n][1], info[n][2]) for n in named],
            norm_groups=norm_groups))
        self._leaves = self._make_leaves(state, info)
        plans, self._sync = {}, []
        for name, p in named.items():
            plan, sums = self._plan(*info[name])
            if plan is not None:
                plans[id(p)] = plan
            else:
                self._sync.append((p, sums))
        self._units = self._make_units(plans)
        self._step_fn = make_train_step(
            self.model, self.config, self.loss_weights,
            apply_masking=self.apply_masking,
            microbatch_steps=self.microbatch_steps,
            rows_group=self.mesh.group("data"), grad_sync=self._sync_grads)
        return state

    def _make_leaves(self, state: TrainState, info) -> List[_Leaf]:
        leaves = []
        named = dict(self.model.named_parameters())
        by_id = {id(p): n for n, p in named.items()}
        for name, p in named.items():
            _, sh, whole, _ = info[name]
            leaves.append(_Leaf(f"params/{name}", lambda p=p: p.data, sh,
                                whole))
        opt = state.optimizer
        inner = opt.inner if isinstance(opt, MultiSteps) else opt
        for p in inner.params:
            name = by_id[id(p)]
            _, sh, whole, _ = info[name]
            st = inner.state[p]
            for key in sorted(st):
                # a factored moment is the mean over the last dim (nu_row)
                # or the one before it (nu_col), kept at the block's rows
                # and columns
                if key == "nu_row":
                    shs, shape = _factor_sharding(sh, len(whole) - 1), \
                        whole[:-1]
                elif key == "nu_col":
                    shs, shape = _factor_sharding(sh, len(whole) - 2), \
                        whole[:-2] + whole[-1:]
                else:
                    shs, shape = sh, whole
                leaves.append(_Leaf(f"opt/{name}/{key}",
                                    lambda st=st, key=key: st[key], shs,
                                    shape))
        if isinstance(opt, MultiSteps):
            for i, p in enumerate(opt.params):
                _, sh, whole, _ = info[by_id[id(p)]]
                leaves.append(_Leaf(f"acc/{by_id[id(p)]}",
                                    lambda i=i: opt.acc[i], sh, whole))
        return leaves

    def _make_units(self, plans) -> Dict[torch.nn.Module, list]:
        """Each unit's gathered parameters, (owner module, name, block,
        plan): the model is the root unit of what no other unit holds."""
        units: Dict[torch.nn.Module, list] = {}
        kinds = _unit_types()

        def walk(mod, unit):
            if isinstance(mod, kinds):
                unit = mod
            for pname, p in mod._parameters.items():
                if p is not None and id(p) in plans:
                    units.setdefault(unit, []).append(
                        (mod, pname, p, plans[id(p)]))
            for child in mod.children():
                walk(child, unit)
        walk(self.model, self.model)
        for unit, entries in units.items():
            unit.register_forward_pre_hook(
                lambda mod, args, e=entries: self._gather(e))
            # also where the forward raises: a checkpoint's recompute stops
            # early by raising inside the block
            unit.register_forward_hook(
                lambda mod, args, out, e=entries: self._free(e),
                always_call=True)
        return units

    def _gather(self, entries) -> None:
        """Before a unit runs: its parameters whole, in their modules."""
        if not self._splitting:
            raise RuntimeError(
                "the model's parameters are this rank's blocks: it runs "
                "inside DistributedTrainer.step; full_params() gives the "
                "whole parameters")
        wholes, handle = comm.gather_unit([e[2] for e in entries],
                                          [e[3] for e in entries])
        self._open.append((entries, handle))
        for (owner, name, _, _), whole in zip(entries, wholes):
            owner._parameters[name] = whole

    def _free(self, entries) -> None:
        """After a unit ran: its blocks back in their modules, the whole
        copies freed (kept by a checkpoint's recompute, which the backward
        frees as it goes)."""
        if not self._splitting:
            return
        done, handle = self._open.pop()
        if done is not entries:
            raise RuntimeError("units closed out of order")
        for owner, name, p, _ in entries:
            owner._parameters[name] = p
        if not remat_sites.is_recomputing():
            handle.release()

    @contextlib.contextmanager
    def _split(self):
        """Inside, the units gather their blocks as they run."""
        self._splitting = True
        comm.reset_gathered_peak()
        try:
            with (comm.saved_whole_hooks([p for p, _ in self._sync])
                  if self._units else contextlib.nullcontext()):
                yield
        finally:
            self._splitting = False
            while self._open:  # a forward that raised
                entries, handle = self._open.pop()
                for owner, name, p, _ in entries:
                    owner._parameters[name] = p
                handle.release()
            self.gathered_peak = comm.gathered_stats["peak"]
            self.made_peak = comm.made_stats["peak"]

    def unit_bytes(self) -> Dict[str, int]:
        """Each unit's gathered bytes (its own parameters, not an inner
        unit's, each whole but for the experts of other 'expert' ranks), by
        module name ('' the root)."""
        names = {m: n for n, m in self.model.named_modules()}
        return {names[u]: sum(math.prod(plan.shape) * p.element_size()
                              for _, _, p, plan in entries)
                for u, entries in self._units.items()}

    def _dtensor(self, leaf: _Leaf):
        from torch.distributed.tensor import DTensor

        dm = self.mesh.device_mesh
        full = torch.empty(leaf.shape, device="meta")
        return DTensor.from_local(leaf.get(), dm, leaf.sharding.placements,
                                  run_check=False, shape=leaf.shape,
                                  stride=full.stride())

    def _sync_grads(self) -> None:
        """Sum the gradients of the parameters used as they are (not
        gathered) over 'data' (rows) and a stacked stage's over 'pipe'
        (stages); a gathered parameter's gradient came back summed."""
        by_groups: Dict[tuple, list] = {}
        for p, groups in self._sync:
            if p.grad is not None and groups:
                by_groups.setdefault(groups, []).append(p.grad)
        with torch.no_grad():
            for groups, grads in by_groups.items():
                for group in groups:
                    comm.all_reduce_(grads, group)

    # -- batches ------------------------------------------------------------- #

    def _rows(self, n: int) -> torch.Tensor:
        """This rank's rows of a global batch of n: its contiguous block
        along 'data', taken microbatch by microbatch when the step
        accumulates (so that its k chunks are its blocks of JAX's k
        microbatches)."""
        w, r, k = self.data_width, self.mesh.coordinate("data"), \
            self.microbatch_steps
        if n % (w * k):
            raise ValueError(f"batch {n} does not divide 'data' {w} x "
                             f"microbatch_steps {k}")
        per_mb, per = n // k, n // (w * k)
        return torch.cat([torch.arange(i * per_mb + r * per,
                                       i * per_mb + (r + 1) * per)
                          for i in range(k)])

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global batch (numpy or tensors; every
        leaf's first dim is the batch), on the model's device."""
        n = int(np.shape(batch["xyzt"])[0])
        idx = self._rows(n)
        whole = bool(torch.equal(idx, torch.arange(n)))
        device = self.generator.device

        def put(x):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            if not whole and t.dim() >= 1 and t.shape[0] == n:
                t = t[idx.to(t.device)]
            return t.to(device)
        return map_leaves(put, batch)

    def shard_batch_from_local(self, local_batch: Dict[str, Any],
                               global_batch_size: int) -> Dict[str, Any]:
        """This rank's rows of the global batch whose process-local share
        (``process_local_batch_indices``: the processes' contiguous blocks
        in process order) ``local_batch`` is: the shares are gathered over
        the world, then split as :meth:`shard_batch` splits."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        n_local = int(np.shape(local_batch["xyzt"])[0])
        if n_local * world != global_batch_size:
            raise ValueError(f"{world} processes x {n_local} local rows != "
                             f"global batch {global_batch_size}")
        device = self.generator.device

        def gather(x):
            t = (x if isinstance(x, torch.Tensor)
                 else torch.as_tensor(np.asarray(x))).to(device)
            if world == 1 or t.dim() == 0 or t.shape[0] != n_local:
                return t
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous())
            return torch.cat(parts)
        return self.shard_batch(map_leaves(gather, local_batch))

    # -- steps --------------------------------------------------------------- #

    def step(self, state: TrainState, batch: Dict[str, Any], *,
             local_of: Optional[int] = None):
        """One train step. With ``local_of=N``, ``batch`` is this process's
        share of a global batch of N rows; otherwise the whole batch.
        ``gathered_peak`` is then the most whole bytes the units held at
        once in it, ``made_peak`` the most bytes of tensors made from them
        alone (casts, concatenations)."""
        local = (self.shard_batch_from_local(batch, local_of)
                 if local_of is not None else self.shard_batch(batch))
        with use_mesh(self.mesh, rows_local=True), self._split():
            state, metrics = self._step_fn(state, local, self.generator)
        return state, metrics

    def _wholes(self, blocks: List[torch.Tensor], leaves: List[_Leaf]
                ) -> List[torch.Tensor]:
        """Copies of the whole leaves of which ``blocks`` are this rank's
        blocks (a collective: one all-gather an axis and dtype)."""
        from torch.distributed.tensor import Shard

        plans = []
        for leaf in leaves:
            axes = tuple(
                comm.GatherAxis(i, self.mesh.group(ax), pl.dim, False)
                for i, (ax, pl) in reversed(list(enumerate(zip(
                    self.mesh.axis_names, leaf.sharding.placements))))
                if isinstance(pl, Shard) and self.mesh.group(ax) is not None)
            plans.append(comm.ParamGather(axes, (), leaf.shape))
        return [w if w is not b else b.clone()
                for w, b in zip(comm._gather_all(blocks, plans), blocks)]

    def full_state(self, prefix: str = "") -> Dict[str, torch.Tensor]:
        """A copy of every state leaf whose key starts with ``prefix``,
        whole (a collective: every rank calls it): ``params/<name>``,
        ``opt/<name>/<moment>`` and ``acc/<name>``."""
        leaves = [leaf for leaf in self._leaves
                  if leaf.key.startswith(prefix)]
        wholes = self._wholes([leaf.get() for leaf in leaves], leaves)
        return {leaf.key[len(prefix):]: w for leaf, w in zip(leaves, wholes)}

    def full_params(self) -> Dict[str, torch.Tensor]:
        """A copy of every parameter whole (a collective), e.g. to evaluate
        or export the trained model."""
        return self.full_state("params/")

    def full_grads(self) -> Dict[str, torch.Tensor]:
        """A copy of every parameter's gradient of the last step whole (a
        collective), by parameter name; a parameter without one is left
        out."""
        leaves = {leaf.key: leaf for leaf in self._leaves}
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.grad is not None]
        wholes = self._wholes([p.grad for _, p in named],
                              [leaves[f"params/{n}"] for n, _ in named])
        return {n: w for (n, _), w in zip(named, wholes)}

    def local_numels(self) -> Dict[str, int]:
        """Each state leaf's stored element count on this rank."""
        return {leaf.key: leaf.get().numel() for leaf in self._leaves}

    def local_bytes(self) -> Dict[str, int]:
        """Each state leaf's stored bytes on this rank."""
        return {leaf.key: leaf.get().numel() * leaf.get().element_size()
                for leaf in self._leaves}

    # -- checkpoints --------------------------------------------------------- #

    def _ckpt_state(self, state: TrainState) -> Dict[str, Any]:
        opt = state.optimizer
        inner = opt.inner if isinstance(opt, MultiSteps) else opt
        out: Dict[str, Any] = {
            "step": torch.tensor(int(state.step)),
            "count": torch.tensor(int(inner.count))}
        if isinstance(opt, MultiSteps):
            out["mini_step"] = torch.tensor(opt.mini_step)
            out["gradient_step"] = torch.tensor(opt.gradient_step)
        for leaf in self._leaves:
            out[leaf.key] = (leaf.get() if self.mesh.device_mesh is None
                             else self._dtensor(leaf))
        return out

    def saved_steps(self) -> List[int]:
        if not self.checkpoint_dir or not os.path.isdir(self.checkpoint_dir):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.checkpoint_dir)
                      if (m := _STEP_DIR.match(f)))

    def save(self, state: TrainState, step: int) -> None:
        """Write the sharded state as ``step_<n>`` under the checkpoint
        directory (``torch.distributed.checkpoint``: each rank writes its
        blocks); keep the latest three."""
        import torch.distributed.checkpoint as dcp

        if self.checkpoint_dir is None:
            raise ValueError("no checkpoint_dir configured")
        done = [step in self.saved_steps()]
        if dist.is_initialized():
            # rank 0's answer: a slower rank could see the directory the
            # save below has begun and skip the collective save
            dist.broadcast_object_list(done, src=0)
        if done[0]:
            return
        path = os.path.join(self.checkpoint_dir, f"step_{step}")
        # each rank writes its blocks from several threads: one thread
        # wrote the 5.04B flagship's 20 GB state at ~0.56 GB/s on an H100
        # host (PERF.md §6)
        dcp.save(self._ckpt_state(state), storage_writer=dcp.FileSystemWriter(
            path, thread_count=SAVE_THREADS), checkpoint_id=path)
        if dist.is_initialized():
            dist.barrier()
        if not dist.is_initialized() or dist.get_rank() == 0:
            for s in self.saved_steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.checkpoint_dir, f"step_{s}"))
        if dist.is_initialized():
            dist.barrier()

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load the latest (or the given) step into ``state``: each rank
        reads its blocks."""
        import torch.distributed.checkpoint as dcp

        if self.checkpoint_dir is None:
            raise ValueError("no checkpoint_dir configured")
        step = step if step is not None else self.saved_steps()[-1]
        target = self._ckpt_state(state)
        dcp.load(target, checkpoint_id=os.path.join(self.checkpoint_dir,
                                                    f"step_{step}"))
        with torch.no_grad():
            for leaf in self._leaves:
                got = target[leaf.key]
                got = got.to_local() if hasattr(got, "to_local") else got
                dst = leaf.get()
                if got.data_ptr() != dst.data_ptr():  # else loaded in place
                    dst.copy_(got)
        opt = state.optimizer
        inner = opt.inner if isinstance(opt, MultiSteps) else opt
        inner.count = int(target["count"])
        if isinstance(opt, MultiSteps):
            opt.mini_step = int(target["mini_step"])
            opt.gradient_step = int(target["gradient_step"])
        state.step = int(target["step"])
        return state

    def fit(self, state: TrainState, batches: Iterable[Dict[str, Any]],
            num_steps: int, log_every: int = 50
            ) -> Tuple[TrainState, Dict[str, float]]:
        from .metrics import MetricAccumulator, format_epoch_line

        acc = MetricAccumulator()
        it = iter(batches)
        metrics: Dict[str, Any] = {}
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        for i in range(1, num_steps + 1):
            state, metrics = self.step(state, next(it))
            acc.update(metrics)
            if log_every and i % log_every == 0 and rank0:
                logger.info(format_epoch_line(i, acc.result()))
                acc.reset()
        return state, {k: float(v) for k, v in metrics.items()}

