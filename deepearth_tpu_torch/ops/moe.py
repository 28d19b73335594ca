"""Mixture-of-experts routing and dispatch, PyTorch port of
``deepearth_tpu/ops/moe.py``.

The gate is DeepSeek-V3's sigmoid, group-limited, bias-corrected top-k
("noaux_tc"). Four ways to run the experts, as in the JAX package:

- :func:`dense_all_expert_ffn`: every token through every expert, combined
  by the gate weights (exact, drop-free; small E);
- capacity dispatch, one-hot (:func:`make_dispatch_combine` and
  :func:`expert_ffn`, the ``dense`` mode of ``MoELayer``) or by gathers
  (:func:`scatter_dispatch_ffn`): each expert takes at most ``capacity``
  tokens, all rank-0 choices before any rank-1 choice, in token order;
- :func:`ragged_expert_ffn`: token copies sorted by expert through the
  grouped matmul K5 (``ops/grouped_matmul.py``), drop-free.

Top-k takes the lower index first among equal values, as ``jax.lax.top_k``
does, and every sort is stable: which tokens an expert drops, and which of
two tied experts wins, follow the JAX package. Nothing here reads a value
back to the host on the card's path.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import grouped_matmul


class GateResult(NamedTuple):
    topk_idx: torch.Tensor  # (N, K) int32
    topk_weight: torch.Tensor  # (N, K) float32
    scores: torch.Tensor  # (N, E) float32 sigmoid scores (before the bias)


def topk_stable(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, largest
    first, the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_gate(logits: torch.Tensor, bias: torch.Tensor, *, top_k: int,
             n_group: int, topk_group: int, norm_topk_prob: bool,
             routed_scaling_factor: float) -> GateResult:
    """Sigmoid group-limited top-k gate.

    Args:
        logits: (N, E) router logits.
        bias: (E,) score-correction bias: it moves the choice only; the
            weights are the sigmoid scores without it.
    """
    n, e = logits.shape
    scores = torch.sigmoid(logits.float())
    for_choice = scores + bias[None, :].float()
    if n_group > 1:
        grouped = for_choice.view(n, n_group, e // n_group)
        group_scores = topk_stable(grouped, min(2, e // n_group))[0].sum(-1)
        group_idx = topk_stable(group_scores, topk_group)[1]
        group_mask = torch.zeros((n, n_group), dtype=torch.bool,
                                 device=logits.device)
        group_mask.scatter_(1, group_idx, True)
        score_mask = group_mask.repeat_interleave(e // n_group, dim=1)
        for_choice = torch.where(score_mask, for_choice, -torch.inf)
    idx = topk_stable(for_choice, top_k)[1]
    weight = torch.gather(scores, 1, idx)
    if top_k > 1 and norm_topk_prob:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    return GateResult(idx.to(torch.int32), weight * routed_scaling_factor,
                      scores)


def make_dispatch_combine(topk_idx: torch.Tensor, topk_weight: torch.Tensor,
                          *, n_experts: int, capacity: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One-hot dispatch and combine tensors (the GShard formulation).

    A token past an expert's capacity is dropped for that expert (combine
    weight 0); all rank-0 choices win capacity before any rank-1 choice.

    Returns dispatch (N, E, C) float32 in {0, 1}, combine (N, E, C) float32
    (dispatch times the gate weight) and load (E,) float32, the assignments
    per expert before capacity.
    """
    n, k = topk_idx.shape
    # (K, N, E), k-major, so lower-rank choices take the first places
    flat = F.one_hot(topk_idx.T.long(), n_experts).float().reshape(
        k * n, n_experts)
    pos = torch.cumsum(flat, dim=0) - flat
    within_cap = (pos < capacity) & (flat > 0)
    pos_capped = torch.where(within_cap, pos, 0.0).long().sum(dim=-1)
    cap_onehot = F.one_hot(pos_capped, capacity).float()
    disp = (within_cap.float()[:, :, None] * cap_onehot[:, None, :]).reshape(
        k, n, n_experts, capacity)
    dispatch = disp.sum(dim=0)
    combine = torch.einsum("knec,nk->nec", disp, topk_weight.float())
    return dispatch, combine, flat.sum(dim=0)


def position_in_expert(topk_idx: torch.Tensor, n_experts: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Queue position of every (token, k) assignment within its expert, the
    order of :func:`make_dispatch_combine`, by one stable sort.

    Returns flat_e (K*N,) expert of each assignment (k-major: i = k N + n),
    pos (K*N,) its place in the expert's queue, and load (E,) float32.
    """
    flat_e = topk_idx.T.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    counts = torch.zeros(n_experts, dtype=torch.long,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts
    pos = rank - starts[flat_e]
    return flat_e.int(), pos.int(), counts.float()


def scatter_dispatch_ffn(xf: torch.Tensor, topk_idx: torch.Tensor,
                         topk_weight: torch.Tensor, w_gate: torch.Tensor,
                         w_up: torch.Tensor, w_down: torch.Tensor,
                         capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch by gathers: the semantics of the one-hot path (the
    same priority, the same drops) in O(N K D) + O(E C D). Each assignment
    gets a slot, dropped ones a trash slot that reads and writes a zero row.

    Returns (N, D) in xf's type and load (E,).
    """
    n, d = xf.shape
    k = topk_idx.shape[1]
    e = w_gate.shape[0]
    flat_e, pos, load = position_in_expert(topk_idx, e)
    slot = torch.where(pos < capacity, flat_e.long() * capacity + pos,
                       e * capacity)
    token_of = torch.arange(n, device=xf.device).repeat(k)  # k-major rows
    # slot -> source token; unfilled slots keep n, the zero row
    inv = torch.full((e * capacity + 1,), n, dtype=torch.long,
                     device=xf.device)
    inv[slot] = token_of
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])
    expert_out = expert_ffn(xf_pad[inv[:-1]].reshape(e, capacity, d),
                            w_gate, w_up, w_down)
    out_pad = torch.cat([expert_out.reshape(e * capacity, d),
                         expert_out.new_zeros((1, d))])
    gathered = out_pad[slot]  # (K*N, D)
    w = topk_weight.T.reshape(-1)[:, None].to(gathered.dtype)
    y = (gathered * w).reshape(k, n, d).sum(dim=0).to(xf.dtype)
    return y, load


def dense_all_expert_ffn(xf: torch.Tensor, topk_idx: torch.Tensor,
                         topk_weight: torch.Tensor, w_gate: torch.Tensor,
                         w_up: torch.Tensor, w_down: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token through every expert, combined by the gate weights:
    drop-free routing with no dispatch. Each expert's gate, up and down
    products come out in the compute type, as JAX's (E, N, F) einsums do;
    the combine sums the E weighted outputs in fp32 and rounds once. The
    experts run one after another, so one expert's (N, F) buffers are live
    at a time, not JAX's (E, N, F).

    Returns (N, D) in xf's type and load (E,), the tokens routed per expert.
    """
    n = xf.shape[0]
    e = w_gate.shape[0]
    # (N, E) gate weights: zeros except each token's K chosen experts
    w_dense = torch.zeros((n, e), dtype=torch.float32,
                          device=xf.device).scatter_add_(
        1, topk_idx.long(), topk_weight.float())
    w_dense = w_dense.to(xf.dtype).float()
    y = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    for i in range(e):
        h = F.silu(xf @ w_gate[i]) * (xf @ w_up[i])
        y += (h @ w_down[i]).float() * w_dense[:, i:i + 1]
    return y.to(xf.dtype), expert_load(topk_idx, e)


def expert_load(topk_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E,) float32 assignments per expert, counted on the device."""
    return torch.zeros(n_experts, dtype=torch.float32,
                       device=topk_idx.device).scatter_add_(
        0, topk_idx.reshape(-1).long(),
        torch.ones(topk_idx.numel(), device=topk_idx.device))


def expert_ffn(expert_in: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Batched SwiGLU experts: expert_in (E, C, D), w_gate and w_up
    (E, D, F), w_down (E, F, D). Returns (E, C, D) in the compute type."""
    h = F.silu(torch.bmm(expert_in, w_gate)) * torch.bmm(expert_in, w_up)
    return torch.bmm(h, w_down)


def load_balance_aux_loss(scores: torch.Tensor, topk_idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e P_e, f_e the share of
    tokens routed to e and P_e its mean normalised score."""
    mask = F.one_hot(topk_idx.long(), n_experts).float().sum(dim=1)
    f = mask.mean(dim=0)
    p = (scores / (scores.sum(dim=-1, keepdim=True) + 1e-20)).mean(dim=0)
    return n_experts * torch.sum(f * p)


def ragged_expert_ffn(xf: torch.Tensor, topk_idx: torch.Tensor,
                      topk_weight: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor
                      ) -> torch.Tensor:
    """Drop-free MoE: token copies sorted by expert (stable), each expert's
    rows through the grouped matmul K5 for gate and up (fp32 out),
    h = silu(gate) up rounded to xf's type, K5 for down, rounded to xf's
    type, unsorted, and the K copies of each token combined by the gate
    weights (fp32 sums, rounded once to xf's type).

    Args:
        xf: (S, D) tokens; topk_idx, topk_weight: (S, K);
        w_gate, w_up: (E, D, F); w_down: (E, F, D).

    Returns (S, D) in xf's type.
    """
    s, d = xf.shape
    k = topk_idx.shape[1]
    e = w_gate.shape[0]
    flat_expert = topk_idx.reshape(-1).long()  # row s K + j is token s
    order = torch.argsort(flat_expert, stable=True)
    sorted_tokens = xf[order // k]
    # the sizes stay on the device: bincount would read its maximum back
    group_sizes = torch.zeros(e, dtype=torch.int32,
                              device=xf.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert, dtype=torch.int32))
    gate = grouped_matmul.gmm(sorted_tokens, w_gate, group_sizes)
    up = grouped_matmul.gmm(sorted_tokens, w_up, group_sizes)
    h = (F.silu(gate) * up).to(xf.dtype)
    out_sorted = grouped_matmul.gmm(h, w_down, group_sizes).to(xf.dtype)
    out_rows = torch.empty_like(out_sorted)
    out_rows[order] = out_sorted  # unsort
    w = topk_weight.to(xf.dtype).float()
    return (out_rows.view(s, k, d).float() * w[..., None]).sum(dim=1).to(
        xf.dtype)
