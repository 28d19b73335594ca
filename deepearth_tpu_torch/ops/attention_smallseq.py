"""Token-major attention for tiny static sequences, PyTorch port.

Counterpart of ``deepearth_tpu/ops/attention_smallseq.py``. The fusion
stack's few universal tokens run token-major, (N, B, D) with D = H * Dh, and
every attention site is a softmax over the Nk keys of each (query, batch
row, head).

:func:`pairwise_token_attention` is a ``torch.autograd.Function`` that
dispatches on the device of its input: for a CUDA tensor the forward and
backward are the hand-written kernels K1-fwd and K1-bwd
(``kernels/csrc/pairwise_attention_fwd_tma.cu`` and
``pairwise_attention_bwd_tma.cu`` where ``kernels.pairwise_fwd_tma_route``
and ``kernels.pairwise_bwd_tma_route`` hold, as at the A-stack's sites,
else ``pairwise_attention.cu`` and ``pairwise_attention_bwd.cu``), for a
CPU tensor their plain PyTorch versions
:func:`pairwise_token_attention_plain` and
:func:`pairwise_token_attention_bwd_plain`.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import kernels

NEG_INF = -1e30  # the finite -inf of the JAX package


@functools.lru_cache(maxsize=32)
def _rope_tables(n: int, head_dim: int, theta: float, device: torch.device,
                 dtype: torch.dtype):
    """cos/sin (N, 1, 1, Dh), half layout, positions 0..N-1, computed in
    float64 and rounded to float32 as the JAX tables are. They are made
    outside inference mode so that a cached table also serves autograd."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    ang = np.arange(n)[:, None] * np.concatenate([inv, inv])[None, :]
    with torch.inference_mode(False):
        cos, sin = (torch.from_numpy(f(ang).astype(np.float32)).to(device, dtype)
                    for f in (np.cos, np.sin))
    return cos[:, None, None, :], sin[:, None, None, :]


def rope_token_major(x: torch.Tensor, n_heads: int,
                     theta: float = 10000.0) -> torch.Tensor:
    """Half-layout RoPE on a token-major (N, B, D) tensor, positions 0..N-1:
    per head, x * cos + rotate_half(x) * sin."""
    n, b, d = x.shape
    head_dim = d // n_heads
    cos, sin = _rope_tables(n, head_dim, float(theta), x.device, x.dtype)
    xh = x.view(n, b, n_heads, head_dim)
    x1, x2 = xh[..., : head_dim // 2], xh[..., head_dim // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (xh * cos + rotated * sin).reshape(n, b, d)


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(N, B, D) -> (N, B, H, Dh) in float32."""
    n, b, d = x.shape
    return x.float().reshape(n, b, n_heads, d // n_heads)


def _probs(qf, kf, scale, key_mask):
    """fp32 softmax over the keys: (Nq, Nk, B, H)."""
    scores = torch.einsum("ibhd,jbhd->ijbh", qf, kf) * scale
    if key_mask is not None:
        scores = torch.where(key_mask.T[None, :, :, None], scores,
                             torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=1, keepdim=True)
    e = torch.exp(scores - m)
    return e / e.sum(dim=1, keepdim=True)


def pairwise_token_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_heads: int,
    scale: float, key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1-fwd (any device, differentiable)."""
    nq, b, d = q.shape
    probs = _probs(_heads(q, n_heads), _heads(k, n_heads), scale, key_mask)
    out = torch.einsum("ijbh,jbhd->ibhd", probs, _heads(v, n_heads))
    out = out.reshape(nq, b, d)
    if key_mask is not None:
        # a query with no visible key outputs zero
        out = torch.where(key_mask.any(dim=1)[None, :, None], out,
                          torch.zeros_like(out))
    return out.to(q.dtype)


def pairwise_token_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    n_heads: int, scale: float, key_mask: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of K1-bwd, the formulas of the JAX package's
    ``_pw_bwd_kernel``: recompute the probabilities, then in fp32

        dv_j = sum_i p_ij do_i            dp_ij = do_i . v_j
        delta_i = sum_j p_ij dp_ij        ds_ij = p_ij (dp_ij - delta_i) scale
        dq_i = sum_j ds_ij k_j            dk_j = sum_i ds_ij q_i

    A batch row with no visible key produced zeros, so all its gradients
    are zero. Returns (dq, dk, dv) in the inputs' dtype.
    """
    nq, b, d = q.shape
    nk = k.shape[0]
    qf, kf, vf = (_heads(x, n_heads) for x in (q, k, v))
    dof = _heads(do, n_heads)
    probs = _probs(qf, kf, scale, key_mask)
    if key_mask is not None:
        probs = probs * key_mask.any(dim=1)[None, None, :, None]
    dv = torch.einsum("ijbh,ibhd->jbhd", probs, dof)
    dp = torch.einsum("ibhd,jbhd->ijbh", dof, vf)
    delta = (probs * dp).sum(dim=1, keepdim=True)
    ds = probs * (dp - delta) * scale
    dq = torch.einsum("ijbh,jbhd->ibhd", ds, kf)
    dk = torch.einsum("ijbh,ibhd->jbhd", ds, qf)
    return (dq.reshape(nq, b, d).to(q.dtype), dk.reshape(nk, b, d).to(k.dtype),
            dv.reshape(nk, b, d).to(v.dtype))


class _PairwiseAttention(torch.autograd.Function):
    """(K1-fwd, K1-bwd) for CUDA tensors, their plain versions for CPU
    tensors. q, k, v are saved as given: the strided views of the fused qkv
    projection go to the backward kernel without a copy."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, n_heads, scale):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.n_heads, ctx.scale = n_heads, scale
        if q.device.type == "cpu":
            return pairwise_token_attention_plain(
                q, k, v, n_heads=n_heads, scale=scale, key_mask=key_mask)
        return kernels.pairwise_attention_fwd(q, k, v, n_heads, scale,
                                              key_mask)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = pairwise_token_attention_bwd_plain(
                q, k, v, dout, n_heads=ctx.n_heads, scale=ctx.scale,
                key_mask=key_mask)
        else:
            dq, dk, dv = kernels.pairwise_attention_bwd(
                q, k, v, dout, ctx.n_heads, ctx.scale, key_mask)
        return dq, dk, dv, None, None, None


def pairwise_token_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_heads: int,
    scale: float, key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention, token-major, tiny static N, differentiable
    with respect to q, k and v.

    Args:
        q: (Nq, B, D); k, v: (Nk, B, D), flat head layout D = H * Dh.
        key_mask: optional (B, Nk) bool, True = visible.

    Returns (Nq, B, D) in q's dtype; the softmax runs in float32.
    """
    return _PairwiseAttention.apply(q, k, v, key_mask, n_heads, scale)
