"""Pipeline parallelism: a GPipe schedule over a mesh axis, PyTorch port
of ``deepearth_tpu/parallel/pipeline.py``.

The model splits into P shape-preserving stages whose parameters are
stacked on a leading axis (:func:`stack_stage_params`); the batch splits
into M microbatches, and M + P - 1 ticks run: at tick t stage p works on
microbatch t - p and hands its activation one hop on. Every stage runs at
every tick, the bubble ticks too, as the JAX package's SPMD program does
(their results never reach the output).

Over a process group for the axis (:func:`pipeline_apply` with a mesh
whose ``axis_name`` has one), rank p keeps stage p: activations (and, in
the model, key masks) go one hop per tick by point-to-point send /
receive, the last stage's outputs are broadcast to every rank of the axis,
and the backward runs the ticks in reverse, recomputing each tick's stage
from its saved input and sending the input's gradient one hop back
(:class:`_PipelineFn`). Stage p's parameter gradients land on rank p. In
one process (no group) the schedule runs every stage at every tick in
turn: JAX's ``vmap`` over stages on one device.

The output, and the gradients, equal the sequential composition of the
stages. M is padded to a multiple of P with zero microbatches, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import comm

Params = Dict[str, torch.Tensor]


def stack_stage_params(stage_params: Sequence[Params]) -> Params:
    """Per-stage parameter dicts (one structure) stacked on a new leading
    'stage' axis."""
    return {name: torch.stack([p[name] for p in stage_params])
            for name in stage_params[0]}


def stage_param_sharding(stacked: Params, mesh, axis_name: str = "pipe"):
    """Each stacked leaf's :class:`~.mesh.Sharding`: the leading stage axis
    over ``axis_name``."""
    from .mesh import Sharding, placements_for

    out = {}
    for name, leaf in stacked.items():
        spec = (axis_name,) + (None,) * (leaf.dim() - 1)
        out[name] = Sharding(mesh, spec, placements_for(spec, mesh))
    return out


StageFn = Callable[[int, torch.Tensor, Optional[torch.Tensor]],
                   Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _feed(x_mb, t):
    return x_mb[min(t, x_mb.shape[0] - 1)]


def gpipe_local(stage_fn: StageFn, n_stages: int, x_mb: torch.Tensor,
                mask_mb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The schedule in one process. ``stage_fn(s, x, mask) -> (y, aux)``
    runs stage s on one microbatch (aux: a vector or None). Stage 0 is fed
    microbatch min(t, M - 1) at tick t (the last one again after the
    last, as JAX feeds it); the other stages start on zeros and all-False
    masks. Returns the (M, mb, ...) outputs and the sum of aux over every
    (tick, stage)."""
    m = x_mb.shape[0]
    acts = [torch.zeros_like(x_mb[0]) for _ in range(n_stages)]
    masks = ([torch.zeros_like(mask_mb[0]) for _ in range(n_stages)]
             if mask_mb is not None else None)
    outs: List[Optional[torch.Tensor]] = [None] * m
    aux_total = None
    for t in range(m + n_stages - 1):
        acts[0] = _feed(x_mb, t)
        if masks is not None:
            masks[0] = _feed(mask_mb, t)
        ys = []
        for s in range(n_stages):
            y, aux = stage_fn(s, acts[s],
                              masks[s] if masks is not None else None)
            ys.append(y)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)] = ys[-1]
        acts = [ys[-1]] + ys[:-1]
        if masks is not None:
            masks = [masks[-1]] + masks[:-1]
    return torch.stack(outs), aux_total


class _PipelineFn(torch.autograd.Function):
    """One rank's stage of the schedule over ``run.group``; inputs:
    (x_mb, mask_mb or None, *the stage's parameters)."""

    @staticmethod
    def forward(ctx, run, x_mb, mask_mb, *params):
        out, aux, saved = run.forward(x_mb, mask_mb, params)
        ctx.run, ctx.saved, ctx.shape = run, saved, x_mb.shape
        ctx.save_for_backward(*params)
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        params = ctx.saved_tensors
        g_x, g_params = ctx.run.backward(ctx.saved, g_out, g_aux, params,
                                         ctx.shape)
        return (None, g_x, None, *g_params)


class _Run:
    """The per-rank schedule: rank ``me`` of ``n`` runs its stage every
    tick; ``stage_fn(x, mask, params) -> (y, aux)``."""

    def __init__(self, stage_fn, n, group, generator=None, n_aux=0):
        self.stage_fn, self.n, self.group = stage_fn, n, group
        self.me = comm.group_rank(group)
        self.generator = generator
        self.n_aux = n_aux

    def _call(self, x, mask, params, gen_state):
        gen = None
        if self.generator is not None:
            gen = torch.Generator(device=self.generator.device)
            gen.set_state(gen_state)
        return self.stage_fn(x, mask, params, gen)

    def forward(self, x_mb, mask_mb, params):
        n, me, m = self.n, self.me, x_mb.shape[0]
        recv_x = torch.zeros_like(x_mb[0])
        recv_m = torch.zeros_like(mask_mb[0]) if mask_mb is not None else None
        outs = [None] * m
        aux_total = torch.zeros(self.n_aux, dtype=torch.float32,
                                device=x_mb.device)
        saved = []
        for t in range(m + n - 1):
            x = _feed(x_mb, t) if me == 0 else recv_x
            mask = None
            if mask_mb is not None:
                mask = _feed(mask_mb, t) if me == 0 else recv_m
            state = (self.generator.get_state()
                     if self.generator is not None else None)
            y, aux = self.stage_fn(x, mask, params, self.generator)
            if aux is not None:
                aux_total = aux_total + aux.float()
            saved.append((x, mask, state))
            if me == n - 1 and t >= n - 1:
                outs[t - (n - 1)] = y
            sends = [y] + ([mask] if mask is not None else [])
            got = [self._hop(s, fwd=True) for s in sends]
            if me > 0:
                recv_x = got[0]
                if mask is not None:
                    recv_m = got[1]
        out = (torch.stack(outs) if me == n - 1
               else torch.empty((m,) + tuple(x_mb.shape[1:]),
                                dtype=x_mb.dtype, device=x_mb.device))
        out = comm.broadcast(out, n - 1, self.group)
        return out, aux_total, saved

    def _hop(self, t: torch.Tensor, fwd: bool) -> Optional[torch.Tensor]:
        """Send ``t`` one stage on (back with ``fwd=False``) and receive
        the one coming from the other side."""
        n, me = self.n, self.me
        if fwd:
            dst = me + 1 if me < n - 1 else None
            src = me - 1 if me > 0 else None
        else:
            dst = me - 1 if me > 0 else None
            src = me + 1 if me < n - 1 else None
        return comm.send_recv(t if dst is not None else None, dst,
                              t if src is not None else None, src,
                              self.group)

    def backward(self, saved, g_out, g_aux, params, x_shape):
        n, me = self.n, self.me
        m = x_shape[0]
        g_x = torch.zeros(x_shape, dtype=g_out.dtype, device=g_out.device)
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        g_params = [torch.zeros_like(p) for p in params]
        g_y = torch.zeros_like(g_out[0])
        for t in reversed(range(m + n - 1)):
            x, mask, state = saved[t]
            if me == n - 1:
                g_y = (g_out[t - (n - 1)] if t >= n - 1
                       else torch.zeros_like(g_out[0]))
            xi = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y, aux = self._call(xi, mask, leaves, state)
                outs, grads = [y], [g_y]
                if aux is not None:
                    outs.append(aux.float())
                    grads.append(g_aux)
                wrt = [xi] + [p for p in leaves if p.requires_grad]
                got = torch.autograd.grad(outs, wrt, grads,
                                          allow_unused=True)
            gx = got[0] if got[0] is not None else torch.zeros_like(xi)
            it = iter(got[1:])
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    gp = next(it)
                    if gp is not None:
                        g_params[i] += gp
            if me == 0:
                g_x[min(t, m - 1)] += gx
            back = self._hop(gx, fwd=False)
            if me < n - 1:
                g_y = back
        g_x = comm.broadcast(g_x, 0, self.group)
        return g_x, g_params


def gpipe_group(stage_fn, params: Sequence[torch.Tensor], x_mb, mask_mb,
                group, generator=None, n_aux: int = 0):
    """The schedule over ``group``: this rank runs its stage,
    ``stage_fn(x, mask, params, generator) -> (y, aux)`` with ``params``
    its stage's tensors. Returns the (M, mb, ...) outputs on every rank of
    the group and this rank's sum of aux over the ticks (``n_aux``
    entries)."""
    run = _Run(stage_fn, comm.group_size(group), group, generator, n_aux)
    return _PipelineFn.apply(run, x_mb, mask_mb, *params)


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stacked_params: Params, x: torch.Tensor, *, mesh,
                   axis_name: str = "pipe",
                   n_microbatches: int) -> torch.Tensor:
    """Run ``stage_{P-1}(... stage_1(stage_0(x)))`` as a GPipe pipeline.

    stage_fn: (one stage's params, (mb, ...) activation) -> the same shape.
    stacked_params: each stage's params stacked on a leading axis of size
    P = ``mesh.shape[axis_name]``. x: the (batch, ...) input, alike on
    every rank of the axis; batch must divide by ``n_microbatches``.
    Returns the (batch, ...) output on every rank of the axis, equal to the
    sequential composition of the stages."""
    n_stages = int(mesh.shape[axis_name])
    lead = next(iter(stacked_params.values())).shape[0]
    if lead != n_stages:
        raise ValueError(
            f"stacked stage axis {lead} != '{axis_name}' size {n_stages}")
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} % microbatches {n_microbatches} "
                         f"!= 0")
    x_mb = x.reshape(n_microbatches, batch // n_microbatches, *x.shape[1:])
    m_pad = -(-n_microbatches // n_stages) * n_stages
    if m_pad != n_microbatches:
        x_mb = torch.cat([x_mb, x_mb.new_zeros(
            (m_pad - n_microbatches,) + tuple(x_mb.shape[1:]))])
    names = list(stacked_params)
    group = mesh.group(axis_name)
    if group is None:
        def one(s, a, _mask):
            return stage_fn({k: stacked_params[k][s] for k in names}, a), None
        out_mb, _ = gpipe_local(one, n_stages, x_mb)
    else:
        me = comm.group_rank(group)

        def mine(a, _mask, params, _gen):
            return stage_fn(dict(zip(names, params)), a), None
        out_mb, _ = gpipe_group(mine, [stacked_params[k][me] for k in names],
                                x_mb, None, group)
    return out_mb[:n_microbatches].reshape(batch, *x.shape[1:])
