"""Scaled-dot-product attention core, PyTorch port of
``deepearth_tpu/ops/attention.py``.

For a CUDA tensor whose shapes pass :func:`attention_vmem.supported`
(non-causal, no bias, 256 <= Nk <= 1024, head dims <= 128) the call goes to
the hand-written kernel K3-fwd, as the JAX package sends those shapes to its
Pallas kernel on the TPU. Everything else is plain torch ops with an fp32
softmax, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import attention_vmem

NEG_INF = -1e30  # finite -inf stand-in: keeps fully masked rows NaN-free


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    key_mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None, is_causal: bool = False,
) -> torch.Tensor:
    """Multi-head attention.

    Args:
        q: (B, H, Nq, Dk); k: (B, H, Nk, Dk); v: (B, H, Nk, Dv).
        scale: softmax scale (already includes any mscale correction).
        key_mask: optional (B, Nk) bool; False keys are masked out.
        attn_bias: optional additive bias broadcastable to (B, H, Nq, Nk).
        is_causal: apply a causal mask (query i sees keys up to
            i + Nk - Nq).

    Returns (B, H, Nq, Dv) in q's dtype; the softmax runs in fp32. A query
    whose keys are all masked outputs zeros.
    """
    if q.is_cuda and attention_vmem.supported(
            q.shape[2], k.shape[2], q.shape[3], v.shape[3], is_causal,
            attn_bias is not None):
        return attention_vmem.vmem_attention(q, k, v, scale=scale,
                                             key_mask=key_mask)

    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if attn_bias is not None:
        scores = scores + attn_bias.float()
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if is_causal:
        nq, nk = scores.shape[-2:]
        causal = torch.ones((nq, nk), dtype=torch.bool,
                            device=q.device).tril(diagonal=nk - nq)
        scores = scores.masked_fill(~causal, NEG_INF)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (probs / probs.sum(dim=-1, keepdim=True)).to(q.dtype)
    dtype = torch.promote_types(probs.dtype, v.dtype)
    out = torch.matmul(probs.to(dtype), v.to(dtype))
    if key_mask is not None:
        out = out.masked_fill(~key_mask.any(dim=-1)[:, None, None, None], 0.0)
    return out
