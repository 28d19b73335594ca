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
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def _use_factored(p: torch.Tensor, min_size: int) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= min_size and p.shape[-2] >= min_size


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's
    ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class FusedAdamW(torch.optim.Optimizer):
    """AdamW with inline global-norm clipping; see the module docstring.

    Args:
        params: the parameters (one group).
        lr: a float, or a schedule mapping the pre-increment count to one.
        clip_norm: clip the gradients' global norm to this (None: no clip),
            as a scale inside the moment update.
        mu_dtype: dtype of the first moment (None: the parameter's).
        second_moment: 'float32' | 'bfloat16' | 'factored'.
    """

    def __init__(self, params, lr: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None,
                 second_moment: str = "float32",
                 min_dim_size_to_factor: int = 128):
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
        for p in self.params:
            self._init_state(p)

    @property
    def params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def _init_state(self, p: torch.Tensor) -> None:
        st = self.state[p]
        st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
        if (self.second_moment == "factored"
                and _use_factored(p, self.min_dim_size_to_factor)):
            st["nu_row"] = torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device)
            st["nu_col"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=torch.float32, device=p.device)
        else:
            nu_dtype = (torch.bfloat16 if self.second_moment == "bfloat16"
                        else torch.float32)
            st["nu"] = torch.zeros_like(p, dtype=nu_dtype)

    def learning_rate(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def step(self, closure=None):
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
            norm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-16),
                                max=1.0)
            gs = torch._foreach_mul([g.float() for g in grads], scale)
        else:
            gs = [g.float() for g in grads]
        factored = ["nu_row" in self.state[p] for p in params]
        for p, g, f in zip(params, gs, factored):
            if f:
                self._factored_leaf(p, g, lr, c1, c2, b1, b2, eps, wd)
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

    def _factored_leaf(self, p, g, lr, c1, c2, b1, b2, eps, wd) -> None:
        st = self.state[p]
        mu = st["mu"].float().mul_(b1).add_((1.0 - b1) * g)
        g2 = g * g
        row = st["nu_row"].mul_(b2).add_((1.0 - b2) * g2.mean(dim=-1))
        col = st["nu_col"].mul_(b2).add_((1.0 - b2) * g2.mean(dim=-2))
        # v_ij = R_i C_j / mean_i(R): exact when g^2 is rank 1
        r_mean = row.mean(dim=-1, keepdim=True)
        vhat = (row[..., :, None] * col[..., None, :]
                / r_mean[..., None].clamp_min(1e-30)) / c2
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
        if second_moment == "factored" and _use_factored(p, 128):
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
