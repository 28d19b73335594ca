"""AdamW with inline global-norm clipping, PyTorch port of
``deepearth_tpu/training/optimizers.py`` (``fused_adamw``).

:class:`FusedAdamW` is a ``torch.optim.Optimizer``. One ``step()`` reads
every gradient once for the global norm, then updates the parameters and
their moments in place (the JAX package writes new arrays; the math is the
same), all leaves at once with PyTorch's multi-tensor ``_foreach`` ops:

    g' = g * min(1, clip_norm / max(||g||, 1e-16))
    mu = b1 mu + (1 - b1) g'            nu = b2 nu + (1 - b2) g'^2
    p += -lr(count) * (mu / c1 / (sqrt(nu / c2) + eps) + wd p)

with optax's count semantics: the learning-rate schedule reads the count
*before* the increment (the first update uses ``lr(0)``), the bias
corrections c1 = 1 - b1^count and c2 = 1 - b2^count the count after it.
Weight decay applies to every parameter, as in the JAX package.

Second-moment layouts: 'float32'; 'bfloat16' (lossy: with b2 = 0.999 the
increment falls below bf16 resolution, kept for experiments); 'factored',
Adafactor-style row and column fp32 factors over a parameter's last two axes
when both are at least ``min_dim_size_to_factor``, nu ~ R C / mean(R). The
first moment is float32 or, with ``mu_dtype=torch.bfloat16``, bf16.

The JAX package concatenates small leaves into one vector to save TPU
launches; the ``_foreach`` ops are the same idea on the GPU (a few
multi-tensor launches instead of ~15 per leaf).

Over ranks that each hold a block of every leaf (``DistributedTrainer``),
``layouts`` gives each parameter its :class:`BlockLayout`: the update runs
on the blocks and stays the whole leaf's. The global norm sums each
element's square once over the ranks (``norm_groups``); a factored leaf's
row and column means sum the block's partial sums over the ranks that
split the reduced dim, then divide by the whole dim's length; whether a
leaf is factored follows its whole shape.
"""

from __future__ import annotations

import math
from typing import (Callable, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.comm import all_reduce_

Schedule = Callable[[int], float]


def _use_factored(shape: Sequence[int], min_size: int) -> bool:
    return (len(shape) >= 2 and shape[-1] >= min_size
            and shape[-2] >= min_size)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's
    ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class BlockLayout(NamedTuple):
    """A parameter held as this rank's block of a whole leaf: the whole
    leaf's ``shape``; for each of its dims the process groups whose ranks
    hold the dim's other parts (``dim_groups``); whether this rank counts
    the block in the global norm (``counted``: one rank of those holding
    the same block)."""

    shape: Tuple[int, ...]
    dim_groups: Tuple[tuple, ...]
    counted: bool = True


def sharded_global_norm(tensors: Sequence[Optional[torch.Tensor]],
                        counted: Sequence[bool], groups: Sequence,
                        device) -> torch.Tensor:
    """The global norm of leaves the ranks hold in blocks: the squares of
    the blocks this rank counts, summed over every group in ``groups`` in
    turn (the mesh's axes), then the square root."""
    mine = [t.float() for t, c in zip(tensors, counted)
            if c and t is not None]
    sq = (torch.stack(torch._foreach_norm(mine)).square().sum() if mine
          else torch.zeros((), dtype=torch.float32, device=device))
    for group in groups:
        dist.all_reduce(sq, group=group)
    return sq.sqrt()


def _sum_over(pairs) -> None:
    """Each tensor summed in place over its groups: one flat all-reduce a
    group (and dtype) for all the tensors that name it."""
    by_group: dict = {}
    for t, groups in pairs:
        for group in groups:
            by_group.setdefault(group, []).append(t)
    for group, tensors in by_group.items():
        all_reduce_(tensors, group)


class FusedAdamW(torch.optim.Optimizer):
    """AdamW with inline global-norm clipping; see the module docstring.

    Args:
        params: the parameters (one group).
        lr: a float, or a schedule mapping the pre-increment count to one.
        clip_norm: clip the gradients' global norm to this (None: no clip),
            as a scale inside the moment update.
        mu_dtype: dtype of the first moment (None: the parameter's).
        second_moment: 'float32' | 'bfloat16' | 'factored'.
        layouts: each parameter's :class:`BlockLayout` where the parameters
            are blocks of whole leaves (None: each is whole).
        norm_groups: the groups the global norm's sum runs over (with
            ``layouts``).
    """

    def __init__(self, params, lr: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None,
                 second_moment: str = "float32",
                 min_dim_size_to_factor: int = 128,
                 layouts: Optional[List[BlockLayout]] = None,
                 norm_groups: Sequence = ()):
        if second_moment not in ("float32", "bfloat16", "factored"):
            raise ValueError(f"unknown second_moment {second_moment!r}")
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.lr = lr
        self.clip_norm = clip_norm
        self.mu_dtype = mu_dtype
        self.second_moment = second_moment
        self.min_dim_size_to_factor = min_dim_size_to_factor
        self.count = 0  # updates applied so far (optax's state.count)
        params = self.params
        if layouts is not None and len(layouts) != len(params):
            raise ValueError(f"{len(layouts)} layouts for {len(params)} "
                             "parameters")
        self.layouts = layouts
        self.norm_groups = tuple(norm_groups)
        for i, p in enumerate(params):
            self._init_state(p, self._layout(i, p))

    @property
    def params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def _layout(self, i: int, p: torch.Tensor) -> BlockLayout:
        if self.layouts is None:
            return BlockLayout(tuple(p.shape), ((),) * p.dim())
        return self.layouts[i]

    def _init_state(self, p: torch.Tensor, layout: BlockLayout) -> None:
        st = self.state[p]
        st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
        if (self.second_moment == "factored"
                and _use_factored(layout.shape, self.min_dim_size_to_factor)):
            st["nu_row"] = torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device)
            st["nu_col"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=torch.float32, device=p.device)
        else:
            nu_dtype = (torch.bfloat16 if self.second_moment == "bfloat16"
                        else torch.float32)
            st["nu"] = torch.zeros_like(p, dtype=nu_dtype)

    def grad_norm(self, grads: Sequence[Optional[torch.Tensor]]
                  ) -> torch.Tensor:
        """The global norm of the whole gradient whose blocks (or whole
        leaves) ``grads`` are, in parameter order (None: a zero)."""
        if self.layouts is None or not self.norm_groups:
            return global_norm(g for g in grads if g is not None)
        return sharded_global_norm(grads, [lay.counted for lay in
                                           self.layouts], self.norm_groups,
                                   self.params[0].device)

    def learning_rate(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def step(self, closure=None, grad_norm: Optional[torch.Tensor] = None):
        """One update; ``grad_norm``: the gradients' :meth:`grad_norm`
        where the caller has it (the clip then needs no collective)."""
        if closure is not None:
            raise ValueError("FusedAdamW.step takes no closure")
        # a parameter without a gradient gets a zero one, as in JAX, where
        # every leaf has a gradient: its moments decay and weight decay acts
        params = self.params
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        group = self.param_groups[0]
        b1, b2, eps, wd = (group[k] for k in ("b1", "b2", "eps",
                                              "weight_decay"))
        lr = self.learning_rate(self.count)  # pre-increment
        self.count += 1
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        if self.clip_norm is not None:
            norm = self.grad_norm(grads) if grad_norm is None else grad_norm
            scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-16),
                                max=1.0)
            gs = torch._foreach_mul([g.float() for g in grads], scale)
        else:
            gs = [g.float() for g in grads]
        factored = ["nu_row" in self.state[p] for p in params]
        self._factored_leaves(
            [(p, g, self._layout(i, p)) for i, (p, g, f) in
             enumerate(zip(params, gs, factored)) if f],
            lr, c1, c2, b1, b2, eps, wd)
        # every other leaf in one sweep of multi-tensor (foreach) kernels
        ps = [p for p, f in zip(params, factored) if not f]
        gs = [g for g, f in zip(gs, factored) if not f]
        if not ps:
            return
        mus = [self.state[p]["mu"].float() for p in ps]  # fp32: in place
        nus = [self.state[p]["nu"].float() for p in ps]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1.0 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1.0 - b2))
        den = torch._foreach_sqrt(torch._foreach_div(nus, c2))
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(torch._foreach_div(mus, c1), den)
        if wd:
            torch._foreach_add_(upd, torch._foreach_mul(
                [p.float() for p in ps], wd))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(ps, [u.to(p.dtype) for u, p in zip(upd, ps)])
        for p, mu, nu in zip(ps, mus, nus):  # moments kept in bf16
            st = self.state[p]
            if st["mu"].dtype != torch.float32:
                st["mu"].copy_(mu)
            if st["nu"].dtype != torch.float32:
                st["nu"].copy_(nu)

    def _factored_leaves(self, items, lr, c1, c2, b1, b2, eps, wd
                         ) -> None:
        """The factored leaves' updates; ``items``: (parameter, fp32
        gradient, layout). Where other ranks hold parts of a reduced dim,
        the block's sums are added over them, all leaves' at once, then
        divided by the whole dim's length."""
        # g is (..., R, C): the groups holding the other columns, the
        # other rows
        splits = [(lay.dim_groups[-1], lay.dim_groups[-2])
                  for _, _, lay in items]
        incs = []
        for (p, g, lay), (c_split, r_split) in zip(items, splits):
            g2 = g * g
            incs.append([g2.sum(dim=-1) if c_split else g2.mean(dim=-1),
                         g2.sum(dim=-2) if r_split else g2.mean(dim=-2)])
        _sum_over([(inc[0], c) for inc, (c, _) in zip(incs, splits)]
                  + [(inc[1], r) for inc, (_, r) in zip(incs, splits)])
        rows, r_sums = [], []
        for (p, g, lay), (c_split, r_split), (row_inc, col_inc) in zip(
                items, splits, incs):
            st = self.state[p]
            n_rows, n_cols = lay.shape[-2], lay.shape[-1]
            if c_split:
                row_inc = row_inc / n_cols
            if r_split:
                col_inc = col_inc / n_rows
            row = st["nu_row"].mul_(b2).add_((1.0 - b2) * row_inc)
            st["nu_col"].mul_(b2).add_((1.0 - b2) * col_inc)
            rows.append(row)
            r_sums.append(row.sum(dim=-1) if r_split
                          else row.mean(dim=-1))
        _sum_over([(t, r) for t, (_, r) in zip(r_sums, splits)])
        for (p, g, lay), (_, r_split), row, r_mean in zip(
                items, splits, rows, r_sums):
            st = self.state[p]
            if r_split:
                r_mean = r_mean / lay.shape[-2]
            col = st["nu_col"]
            mu = st["mu"].float().mul_(b1).add_((1.0 - b1) * g)
            # v_ij = R_i C_j / mean_i(R): exact when g^2 is rank 1
            vhat = (row[..., :, None] * col[..., None, :]
                    / r_mean[..., None, None].clamp_min(1e-30)) / c2
            upd = (mu / c1) / (vhat.sqrt() + eps)
            if wd:
                upd = upd + wd * p.float()
            if st["mu"].dtype != torch.float32:
                st["mu"].copy_(mu)
            p.add_((-lr * upd).to(p.dtype))

    def state_dict(self):
        """The count and each parameter's moments, in parameter order (the
        moments keep their dtypes; the schedule is not saved)."""
        return {"count": self.count,
                "state": [dict(self.state[p]) for p in self.params]}

    def load_state_dict(self, state_dict):
        states = state_dict["state"]
        if len(states) != len(self.params):
            raise ValueError("optimizer state has another parameter count")
        with torch.no_grad():
            for p, saved in zip(self.params, states):
                st = self.state[p]
                if set(saved) != set(st):
                    raise ValueError(f"moment layout {sorted(saved)} != "
                                     f"{sorted(st)}")
                for k, v in saved.items():
                    if v.shape != st[k].shape:
                        raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                         f"{tuple(st[k].shape)}")
                    st[k].copy_(v)
        self.count = int(state_dict["count"])


def optimizer_state_bytes(params: Iterable[torch.Tensor],
                          second_moment: str = "float32",
                          mu_dtype: Optional[torch.dtype] = None) -> int:
    """Predicted optimizer-state footprint (moments only) in bytes."""
    total = 0
    for p in params:
        mu_itemsize = (mu_dtype or p.dtype).itemsize
        total += p.numel() * mu_itemsize
        if second_moment == "factored" and _use_factored(p.shape, 128):
            total += 4 * (math.prod(p.shape[:-1])
                          + math.prod(p.shape[:-2] + p.shape[-1:]))
        else:
            total += p.numel() * (2 if second_moment == "bfloat16" else 4)
    return total


def _like(params, items):
    """``items`` in the container type of ``params`` (a tuple or a
    NamedTuple)."""
    items = list(items)
    return type(params)(*items) if hasattr(params, "_fields") else tuple(items)


class AdamState(NamedTuple):
    """:class:`Adam`'s state: the update count and both moments, each in
    the container of the parameters."""

    count: int
    mu: tuple
    nu: tuple

    def remap(self, src_rows) -> "AdamState":
        """Both moments of row i taken from row ``src_rows[i]`` of every
        leaf: rows added by a resize inherit their source row's moments."""
        src = torch.as_tensor(np.asarray(src_rows), dtype=torch.long,
                              device=self.mu[0].device)
        return AdamState(self.count, _like(self.mu, (t[src] for t in self.mu)),
                         _like(self.nu, (t[src] for t in self.nu)))


class Adam:
    """``optax.adam(lr)`` over a tuple or NamedTuple of tensors, functional
    as optax is: ``init(params)``, then ``update(grads, state)`` returns
    the updates to add and the new state. Bias-corrected moments, ``eps``
    outside the square root, in optax's order of operations (the bias
    corrections 1 - b^count in fp32)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> AdamState:
        return AdamState(0, _like(params, map(torch.zeros_like, params)),
                         _like(params, map(torch.zeros_like, params)))

    def update(self, grads, state: AdamState) -> Tuple[tuple, AdamState]:
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        mu = _like(grads, ((1 - b1) * g + b1 * m
                           for g, m in zip(grads, state.mu)))
        nu = _like(grads, ((1 - b2) * g ** 2 + b2 * v
                           for g, v in zip(grads, state.nu)))
        c1, c2 = (1 - torch.tensor(b, device=grads[0].device) ** count
                  for b in (b1, b2))
        updates = _like(grads, (
            -self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps))
            for m, v in zip(mu, nu)))
        return updates, AdamState(count, mu, nu)
