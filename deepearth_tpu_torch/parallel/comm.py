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

``ring_shift`` moves tensors one hop around the group by point-to-point
send / receive. A group of one rank (or ``None``) makes every function here
the identity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


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
    out = x.clone()
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
