"""Collectives over one process group, with the two gradient conventions
the port's multi-rank paths use.

* **Row split** (``gather_rows``, ``all_reduce_rows``,
  ``rows_to_shares`` / ``shares_to_rows``): each rank holds its own rows of
  a tensor and the ranks' objectives are summed. The gather's backward
  sums the gradient over the ranks, then each rank keeps its rows
  (reduce-scatter); the sum's backward is a sum.
* **Replicated** (``gather_replicated``, ``all_reduce_replicated``): the
  computation after the collective is the same on every rank, so every
  rank already holds the whole gradient; the backward keeps this rank's
  part (a gather) or passes it on (a sum) with no communication.
* **Split** (``split_inputs``): ranks that each compute a part of one
  result from the same input (an MoE layer's experts split over 'expert')
  take the input as it is; the backward sums its gradient over the group.
  ``all_reduce_replicated`` then adds the parts.

``ring_shift`` moves tensors one hop around the group by point-to-point
send / receive. A group of one rank (or ``None``) makes every function here
the identity.

Parameters stored as this rank's blocks of the whole leaves
(``DistributedTrainer``) are made whole by :func:`gather_unit` just before
the unit that uses them runs: all-gathers over each axis that splits them,
one for all of the unit's blocks of a dtype; the backward hands each block
its part of the whole gradient, summed over the axes whose ranks split the
batch's rows (a reduce-scatter) and taken without a sum over the others,
where every rank computed the same gradient. The whole copies are freed
(their storage resized to 0) once the unit has run and gathered again
when the backward unpacks a tensor that autograd saved from one of them
(:func:`saved_whole_hooks`). A tensor made from the whole copies and the
parameters used as they are alone (a cast to the compute dtype, a
concatenation of weights) is not kept either: autograd keeps how it was
made, and the backward makes it again. ``gathered_stats`` counts the whole copies' bytes
held, ``made_stats`` those of the tensors made from them.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _empty(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [_empty(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _own_chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x.chunk(group_size(group), dim=dim)[group_rank(group)]


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return _own_chunk(g, ctx.group, ctx.dim).contiguous(), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group, ctx.dim).contiguous(), None, None


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitInputs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllReduceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def _to_shares(x: torch.Tensor, group, m: int) -> torch.Tensor:
    n, me = group_size(group), group_rank(group)
    full = _all_gather_cat(x, group, 0)
    share = full.shape[0] // (m * n)
    return full.reshape(m, n, share, *full.shape[1:])[:, me].reshape(
        m * share, *full.shape[1:])


def _to_rows(x: torch.Tensor, group, m: int) -> torch.Tensor:
    n, me = group_size(group), group_rank(group)
    full = _all_gather_cat(x, group, 0)
    share = full.shape[0] // (m * n)
    rows = full.reshape(n, m, share, *full.shape[1:]).transpose(0, 1)
    return rows.reshape(m * n, share, *full.shape[1:])[
        me * m:(me + 1) * m].reshape(m * share, *full.shape[1:])


class _RowsToShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, m):
        ctx.group, ctx.m = group, m
        return _to_shares(x, group, m)

    @staticmethod
    def backward(ctx, g):
        return _to_rows(g, ctx.group, ctx.m), None, None


class _SharesToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, m):
        ctx.group, ctx.m = group, m
        return _to_rows(x, group, m)

    @staticmethod
    def backward(ctx, g):
        return _to_shares(g, ctx.group, ctx.m), None, None


def _apply(fn, raw, x, *args):
    if not (torch.is_grad_enabled() and x.requires_grad):
        return raw(x, *args)
    return fn.apply(x, *args)


def rows_to_shares(x: torch.Tensor, group, m: int) -> torch.Tensor:
    """From each rank's block of rows of a global batch to its share of
    each of the batch's ``m`` microbatches: microbatch j's rows split in
    rank order, this rank's part of each in turn (row split; the backward
    is :func:`shares_to_rows` of the gradient). Each microbatch's row count
    must divide by the group's size."""
    if group_size(group) == 1:
        return x
    return _apply(_RowsToShares, _to_shares, x, group, m)


def shares_to_rows(x: torch.Tensor, group, m: int) -> torch.Tensor:
    """The inverse of :func:`rows_to_shares`."""
    if group_size(group) == 1:
        return x
    return _apply(_SharesToRows, _to_rows, x, group, m)


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' parts of ``x`` concatenated along ``dim`` in rank order;
    under the row-split convention (the backward sums over the ranks). A
    tensor without grad is gathered without an autograd node."""
    if group_size(group) == 1:
        return x
    return _apply(_GatherRows, _all_gather_cat, x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """As :func:`gather_rows`, under the replicated convention (the
    backward keeps this rank's part of the gradient, no communication)."""
    if group_size(group) == 1:
        return x
    return _apply(_GatherReplicated, _all_gather_cat, x, group, dim)


def all_reduce_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, under the row-split convention (the
    backward sums the gradient over the group)."""
    if group_size(group) == 1:
        return x
    return _apply(_AllReduceRows, _sum, x, group)


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group; the backward passes the gradient on
    unchanged (replicated convention)."""
    if group_size(group) == 1:
        return x
    return _apply(_AllReduceReplicated, _sum, x, group)


def split_inputs(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, entering a computation that the group's ranks split
    (each a part of one result, added by :func:`all_reduce_replicated`): the
    backward sums the ranks' partial gradients over the group."""
    if group_size(group) == 1:
        return x
    return _apply(_SplitInputs, lambda t, _g: t, x, group)


def _flat(tensors: Sequence[torch.Tensor], collective) -> None:
    """``collective`` on one flat buffer a dtype, copied back in place."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_reduce_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over the group in place."""
    if group_size(group) > 1 and tensors:
        _flat(tensors, lambda f: dist.all_reduce(f, group=group))


def broadcast_(tensors: Sequence[torch.Tensor], group) -> None:
    """Overwrite each tensor with the group's first rank's."""
    if group_size(group) > 1 and tensors:
        src = dist.get_process_group_ranks(group)[0]
        _flat(tensors, lambda f: dist.broadcast(f, src, group=group))


def broadcast(x: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """``x`` from the rank at ``src_index`` of the group, on every rank (in
    place on the others)."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    dist.broadcast(x, dist.get_process_group_ranks(group)[src_index],
                   group=group)
    return x


def ring_shift(tensors: Sequence[torch.Tensor], group, step: int = 1
               ) -> List[torch.Tensor]:
    """Each tensor sent to the rank ``step`` places further on in the
    group and replaced by the one from ``step`` places back, by
    point-to-point send / receive."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    ranks = dist.get_process_group_ranks(group)
    me = group_rank(group)
    dst, src = ranks[(me + step) % n], ranks[(me - step) % n]
    outs = [_empty(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return outs


def send_recv(send: Optional[torch.Tensor], dst_index: Optional[int],
              recv_like: Optional[torch.Tensor], src_index: Optional[int],
              group) -> Optional[torch.Tensor]:
    """Send ``send`` to the rank at ``dst_index`` of the group and receive a
    tensor shaped as ``recv_like`` from ``src_index`` (either may be None);
    returns the received tensor."""
    ranks = dist.get_process_group_ranks(group)
    ops, out = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              ranks[dst_index], group))
    if recv_like is not None:
        out = _empty(recv_like)
        ops.append(dist.P2POp(dist.irecv, out, ranks[src_index], group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


# -- parameters held in blocks ------------------------------------------------ #


class GatherAxis(NamedTuple):
    """One mesh axis that splits a parameter: its place in the mesh's axes
    (``index``), its process group, the tensor dim it splits, and whether
    the parameter's gradient is summed over it (its ranks computed
    different rows) or each rank takes its block of the gradient all of
    them computed alike."""

    index: int
    group: object
    dim: int
    summed: bool


class ParamGather(NamedTuple):
    """How a block becomes its whole parameter: ``axes`` gathered in turn,
    the minor mesh axis first (a dim split over several axes is split major
    to minor in mesh order); ``sum_groups`` the groups of the axes that hold
    the block whole and whose ranks split the rows, over which the block's
    gradient is summed; ``shape`` the gathered tensor's (the whole
    parameter's but on a dim left split, an MoE layer's experts over
    'expert')."""

    axes: Tuple[GatherAxis, ...]
    sum_groups: tuple
    shape: Tuple[int, ...]


# whole bytes held by gathered parameters: now and the most since a reset
gathered_stats: Dict[str, int] = {"live": 0, "peak": 0}
# the same for the tensors made from them alone (casts, concatenations)
made_stats: Dict[str, int] = {"live": 0, "peak": 0}
# storage address -> the UnitGather whose whole copy lives there, while the
# unit that gathered it runs (saved_whole_hooks reads it)
_LIVE: Dict[int, "UnitGather"] = {}


def reset_gathered_peak() -> None:
    for stats in (gathered_stats, made_stats):
        stats["peak"] = stats["live"]


def _batches(tensors: Sequence[Optional[torch.Tensor]], plans, index: int):
    """The tensors split over mesh axis ``index``, by dtype: lists of
    (position, the axis's entry in the plan)."""
    out: Dict[torch.dtype, list] = {}
    for i, (t, plan) in enumerate(zip(tensors, plans)):
        ax = next((a for a in plan.axes if a.index == index), None)
        if t is not None and ax is not None:
            out.setdefault(t.dtype, []).append((i, ax))
    return out.values()


def _gather_all(blocks: Sequence[torch.Tensor], plans) -> List[torch.Tensor]:
    """Every block made whole: axis by axis, the minor first, one
    all-gather for all the blocks of a dtype split over the axis (each
    with its split dim moved first and flattened, concatenated)."""
    xs = list(blocks)
    indices = sorted({a.index for p in plans for a in p.axes}, reverse=True)
    for index in indices:
        for batch in _batches(xs, plans, index):
            group = batch[0][1].group
            n = group_size(group)
            moved = [xs[i].movedim(ax.dim, 0).contiguous() for i, ax in batch]
            send = torch.cat([m.reshape(-1) for m in moved])
            out = torch.empty(n * send.numel(), dtype=send.dtype,
                              device=send.device)
            dist.all_gather_into_tensor(out, send, group=group)
            out = out.view(n, send.numel())
            off = 0
            for (i, ax), m in zip(batch, moved):
                part = out[:, off:off + m.numel()].reshape(
                    (n * m.shape[0],) + tuple(m.shape[1:]))
                xs[i] = part.movedim(0, ax.dim)
                off += m.numel()
    return [x.contiguous() for x in xs]


def _block_grads(grads: Sequence[Optional[torch.Tensor]], plans
                 ) -> List[Optional[torch.Tensor]]:
    """Each whole gradient's part for this rank's block: axis by axis, the
    major first, one reduce-scatter for the gradients of a dtype summed
    over the axis, this rank's block of the others; then one sum over each
    set of ``sum_groups``. A None gradient stays None."""
    gs = list(grads)
    indices = sorted({a.index for p in plans for a in p.axes})
    for index in indices:
        for batch in _batches(gs, plans, index):
            group = batch[0][1].group
            n, me = group_size(group), group_rank(group)
            summed = [(i, ax, gs[i].movedim(ax.dim, 0).contiguous())
                      for i, ax in batch if ax.summed]
            for i, ax in batch:
                if not ax.summed:
                    gs[i] = gs[i].movedim(ax.dim, 0).chunk(n)[me].movedim(
                        0, ax.dim)
            if not summed:
                continue
            send = torch.cat([m.reshape(n, -1) for _, _, m in summed], 1)
            out = torch.empty(send.shape[1], dtype=send.dtype,
                              device=send.device)
            dist.reduce_scatter_tensor(out, send.reshape(-1), group=group)
            off = 0
            for i, ax, m in summed:
                size = m.numel() // n
                gs[i] = out[off:off + size].view(
                    (m.shape[0] // n,) + tuple(m.shape[1:])).movedim(
                    0, ax.dim)
                off += size
    gs = [None if g is None else g.contiguous() for g in gs]
    by_groups: Dict[tuple, list] = {}
    for g, plan in zip(gs, plans):
        if g is not None and plan.sum_groups:
            by_groups.setdefault(plan.sum_groups, []).append(g)
    for groups, tensors in by_groups.items():
        for group in groups:
            all_reduce_(tensors, group)
    return gs


class UnitGather:
    """The whole copies of one unit's parameters, gathered together from
    this rank's blocks. Their bytes count in ``gathered_stats`` while their
    storage is held: from the gather to :meth:`release` (or a copy's end),
    and again from :meth:`ensure`, which gathers them anew into the same
    storage."""

    def __init__(self, blocks: Sequence[torch.Tensor], plans):
        self.blocks, self.plans = list(blocks), list(plans)
        self.nbytes = [math.prod(p.shape) * b.element_size()
                       for b, p in zip(self.blocks, self.plans)]
        self.refs: list = []
        self.held = [False] * len(self.blocks)
        self.keys: list = []

    def gather(self) -> List[torch.Tensor]:
        return _gather_all([b.detach() for b in self.blocks], self.plans)

    def track(self, wholes: Sequence[torch.Tensor]) -> None:
        for i, whole in enumerate(wholes):
            self.refs.append(weakref.ref(whole))
            weakref.finalize(whole, self._drop, i)
            key = whole.untyped_storage().data_ptr()
            self.keys.append(key)
            _LIVE[key] = self
            self._hold(i)

    def ensure(self) -> None:
        """Every whole copy that is still referred to, its storage back and
        gathered anew (all of the unit's at once)."""
        wholes = [ref() for ref in self.refs]
        if all(w is None or h for w, h in zip(wholes, self.held)):
            return
        fresh = self.gather()
        with torch.no_grad():
            for i, (whole, new) in enumerate(zip(wholes, fresh)):
                if whole is None or self.held[i]:
                    continue
                whole.untyped_storage().resize_(self.nbytes[i])
                whole.data.copy_(new)
                self._hold(i)

    def release(self) -> None:
        for i, ref in enumerate(self.refs):
            if _LIVE.get(self.keys[i]) is self:
                del _LIVE[self.keys[i]]
            whole = ref()
            if whole is not None and self.held[i]:
                whole.untyped_storage().resize_(0)
                self._drop(i)

    def _hold(self, i: int) -> None:
        self.held[i] = True
        gathered_stats["live"] += self.nbytes[i]
        gathered_stats["peak"] = max(gathered_stats["peak"],
                                     gathered_stats["live"])

    def _drop(self, i: int) -> None:
        if self.held[i]:
            self.held[i] = False
            gathered_stats["live"] -= self.nbytes[i]
        if i < len(self.keys) and _LIVE.get(self.keys[i]) is self:
            del _LIVE[self.keys[i]]


class _GatherUnit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, handle, *blocks):
        ctx.handle = handle
        ctx.set_materialize_grads(False)
        return tuple(handle.gather())

    @staticmethod
    def backward(ctx, *grads):
        out = _block_grads(grads, ctx.handle.plans)
        ctx.handle.release()  # every use of the whole copies is done
        return (None, *out)


def gather_unit(blocks: Sequence[torch.Tensor], plans
                ) -> Tuple[List[torch.Tensor], UnitGather]:
    """The whole parameters of one unit from this rank's ``blocks`` (see
    the module docstring; one collective an axis and dtype for them all)
    and their :class:`UnitGather` handle; under grad the backward returns
    each block's gradient."""
    handle = UnitGather(blocks, plans)
    if torch.is_grad_enabled() and any(b.requires_grad for b in blocks):
        wholes = list(_GatherUnit.apply(handle, *blocks))
    else:
        wholes = handle.gather()
    handle.track(wholes)
    return wholes, handle


class _Made(NamedTuple):
    """How a tensor was made from one unit's whole copies (``handle``'s;
    None: from parameters used as they are) and such parameters alone:
    ``func`` over ``args`` / ``kwargs``, where each tensor stands as a
    :class:`_Ref`."""

    handle: Optional[UnitGather]
    func: object
    args: tuple
    kwargs: dict


class _Ref(NamedTuple):
    """A tensor of a :class:`_Made` recipe: a whole copy or a parameter (or
    a view of one), kept as it is (``tensor``; a copy's storage comes back
    with its unit's gather), or a view (``geometry``) of what another
    recipe (``made``) makes."""

    tensor: Optional[torch.Tensor]
    made: Optional[_Made]
    geometry: Optional[tuple]


# storage address -> how the tensor there was made from whole copies, while
# that storage lives
_MADE: Dict[int, _Made] = {}
# storage addresses of the parameters used as they are (not gathered), under
# saved_whole_hooks
_SOURCES: set = set()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _geometry(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.storage_offset()


def _count(t: torch.Tensor) -> None:
    """Count ``t``'s storage in ``made_stats`` while it lives."""
    n = t.untyped_storage().nbytes()
    made_stats["live"] += n
    made_stats["peak"] = max(made_stats["peak"], made_stats["live"])
    weakref.finalize(t.untyped_storage(), _uncount, n)


def _uncount(n: int) -> None:
    made_stats["live"] -= n


def _ref(t: torch.Tensor) -> Optional[Tuple[Optional[UnitGather], _Ref]]:
    key = _key(t)
    handle = _LIVE.get(key)
    if handle is not None or key in _SOURCES:
        return handle, _Ref(t, None, None)
    made = _MADE.get(key)
    if made is not None:
        return made.handle, _Ref(None, made, _geometry(t))
    return None


def _refs(xs, refs: list):
    """``xs`` (a tuple, list or dict of arguments) with each tensor as its
    :class:`_Ref`, collecting the handles in ``refs``; None where a tensor
    is not made from whole copies."""
    out = []
    for x in (xs.values() if isinstance(xs, dict) else xs):
        if isinstance(x, (list, tuple)):
            if hasattr(x, "_fields"):
                return None
            x = _refs(x, refs)
            if x is None:
                return None
        elif isinstance(x, torch.Generator):  # not made again alike
            return None
        elif isinstance(x, torch.Tensor):
            found = _ref(x)
            if found is None:
                return None
            refs.append(found[0])
            x = found[1]
        out.append(x)
    if isinstance(xs, dict):
        return dict(zip(xs, out))
    return type(xs)(out) if isinstance(xs, tuple) else out


def _make(made: _Made) -> torch.Tensor:
    """The tensor ``made`` describes, made again (its unit's whole copies
    gathered again first)."""
    if made.handle is not None:
        made.handle.ensure()

    def real(x):
        if isinstance(x, _Ref):
            if x.tensor is not None:
                return x.tensor
            size, stride, offset = x.geometry
            return _make(x.made).as_strided(size, stride, offset)
        if isinstance(x, (list, tuple)):
            return type(x)(real(y) for y in x)
        return x

    with torch.no_grad():
        out = made.func(*real(made.args),
                        **{k: real(v) for k, v in made.kwargs.items()})
    _count(out)
    return out


_IN_PLACE = {f"__i{op}__" for op in (
    "add", "sub", "mul", "matmul", "truediv", "floordiv", "mod", "pow",
    "and", "or", "xor", "lshift", "rshift")} | {"__setitem__"}


def _in_place(func) -> bool:
    name = getattr(func, "__name__", "")
    return (name.endswith("_") and not name.endswith("__")) \
        or name in _IN_PLACE


class _RecordMade(TorchFunctionMode):
    """Records each new tensor autograd tracks that a function makes from
    tensors all made from one unit's whole copies and the parameters used
    as they are (:data:`_MADE`)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _MADE and args and isinstance(args[0], torch.Tensor) \
                and _in_place(func):
            # changed in place: kept from here on as it is
            _MADE.pop(_key(args[0]), None)
        out = func(*args, **kwargs)
        if (not (_LIVE or _SOURCES) or not isinstance(out, torch.Tensor)
                or not out.requires_grad or out.numel() == 0):
            return out
        key = _key(out)
        if key in _LIVE or key in _MADE or key in _SOURCES:  # a view
            return out
        handles: list = []
        a = _refs(args, handles)
        k = None if a is None else _refs(kwargs, handles)
        units = {id(h): h for h in handles if h is not None}
        if k is None or not handles or len(units) > 1:
            return out
        _MADE[key] = _Made(next(iter(units.values()), None), func, a, k)
        weakref.finalize(out.untyped_storage(), _MADE.pop, key, None)
        _count(out)
        return out


class _SavedWhole:
    __slots__ = ("handle", "tensor")

    def __init__(self, handle: UnitGather, tensor: torch.Tensor):
        self.handle, self.tensor = handle, tensor


def _pack(t: torch.Tensor):
    if _LIVE or _MADE:
        key = _key(t)
        handle = _LIVE.get(key)
        if handle is not None:
            return _SavedWhole(handle, t)
        made = _MADE.get(key)
        if made is not None:
            return _Ref(None, made, _geometry(t))
    return t


def _unpack(x):
    if isinstance(x, _SavedWhole):
        x.handle.ensure()
        return x.tensor
    if isinstance(x, _Ref):
        size, stride, offset = x.geometry
        return _make(x.made).as_strided(size, stride, offset)
    return x


@contextlib.contextmanager
def saved_whole_hooks(params: Sequence[torch.Tensor] = ()):
    """``saved_tensors_hooks`` under which a tensor autograd saves from a
    gathered whole parameter (the copy or a view of it) does not keep the
    copy's bytes: the copies are released after their unit runs, and
    gathered again into their storage when the backward unpacks one of
    them. A tensor made from one unit's copies and ``params`` (the
    parameters used as they are) alone is recorded when it is made and
    saved as its recipe; the backward makes it again. Inside a checkpointed
    block the checkpoint's own hooks apply: its recompute gathers anew."""
    _SOURCES.update(_key(p) for p in params)
    try:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack), \
                _RecordMade():
            yield
    finally:
        _SOURCES.clear()
