"""Long-sequence attention with an online softmax, PyTorch port of the
library flash attention (``jax.experimental.pallas.ops.tpu.flash_attention``)
that ``deepearth_tpu/models/deepseek.py`` ``MLAttention`` calls on the TPU
for sequences of at least ``flash_min_seq`` tokens: the vision encoder over
the 4608 patches of a V-JEPA2 clip.

:func:`flash_attention` is a ``torch.autograd.Function``: for CUDA tensors
the hand-written kernels K4-fwd and K4-bwd
(``kernels/csrc/flash_attention.cu``), for CPU tensors their plain PyTorch
versions :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`.
The forward saves each row's log-sum-exp; the backward recomputes the
probabilities from it and takes ``di = rowsum(out o dout)``, as the
library's backward does.

What the port does not copy from the JAX call site: the TPU layout (v
zero-padded to q's head dim, N padded to a multiple of 128, segment ids for
the pads and the key mask). The kernels take Dqk != Dv, any N and a (B, N)
key mask. One semantic difference is kept on purpose: a query whose keys are
all masked outputs 0, the repository's convention, where the library kernel
outputs the mean of v (it adds a finite mask value and guards only a zero
sum).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .attention_vmem import NEG_BIG

MAX_DIM = kernels.ATTN_MAX_DIM


def supported(dqk: int, dv: int) -> bool:
    """Head dims the kernels take (any N, any mask, causal or not)."""
    return 1 <= dqk <= MAX_DIM and 1 <= dv <= MAX_DIM


def _scores(q, k, scale, key_mask, causal):
    """fp32 scores and the (broadcast) visibility mask, or None."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    visible = None
    if key_mask is not None:
        visible = key_mask[:, None, None, :]
    if causal:
        nq, nk = s.shape[-2:]
        tril = torch.ones((nq, nk), dtype=torch.bool, device=q.device).tril()
        visible = tril if visible is None else visible & tril
    return s, visible


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float,
                          key_mask: Optional[torch.Tensor] = None,
                          causal: bool = False, return_lse: bool = False):
    """Plain PyTorch version of K4-fwd on full rows (any device,
    differentiable): fp32 scores, the key mask and (``causal``) key j
    visible to query i iff j <= i as an additive 0 / NEG_BIG bias, the
    guarded softmax (a row whose keys are all masked gives 0), p rounded to
    v's dtype, P.V in fp32, rounded once to q's dtype. With ``return_lse``
    also each row's log-sum-exp in fp32, +inf for an all-masked row."""
    s, visible = _scores(q, k, scale, key_mask, causal)
    if visible is not None:
        s = s + torch.where(visible, 0.0, NEG_BIG).to(torch.float32)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = (e / l.clamp_min(1e-30)).to(v.dtype)
    out = torch.matmul(p.float(), v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]
    return out, lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              scale: float,
                              key_mask: Optional[torch.Tensor] = None,
                              causal: bool = False):
    """Plain PyTorch version of K4-bwd on full rows, the library's flash
    backward: p = exp(s - lse), 0 where masked; di = rowsum(out o dout) in
    fp32; dv = (p -> dout's dtype)^T . dout; ds = p (dout . v^T - di) scale;
    dq = (ds -> k's dtype) . k; dk = (ds -> q's dtype)^T . q; fp32 sums,
    each rounded once. Returns (dq, dk, dv)."""
    s, visible = _scores(q, k, scale, key_mask, causal)
    p = torch.exp(s - lse[..., None])
    if visible is not None:
        p = torch.where(visible, p, 0.0)
    do = dout.float()
    di = (out.float() * do).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), do)
    ds = (torch.matmul(do, v.float().transpose(-1, -2)) - di) * p * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """K4-fwd and K4-bwd for CUDA tensors, their plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale, causal):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale=scale,
                                             key_mask=key_mask,
                                             causal=causal, return_lse=True)
        else:
            out, lse = kernels.flash_attention_fwd(q, k, v, scale, key_mask,
                                                   causal)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_bwd_plain(
                q, k, v, out, lse, dout, scale=ctx.scale, key_mask=key_mask,
                causal=ctx.causal)
        else:
            grads = kernels.flash_attention_bwd(q, k, v, out, lse, dout,
                                                ctx.scale, key_mask,
                                                ctx.causal)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, key_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Multi-head attention over long sequences, the JAX package's layout.

    Args:
        q: (B, H, Nq, Dqk); k: (B, H, Nk, Dqk); v: (B, H, Nk, Dv); head dims
            at most 128.
        key_mask: optional (B, Nk) bool, False = masked out.
        causal: key j is visible to query i iff j <= i.

    Returns (B, H, Nq, Dv) in q's dtype; the softmax runs in fp32.
    """
    return _FlashAttention.apply(q, k, v, key_mask, float(scale),
                                 bool(causal))
