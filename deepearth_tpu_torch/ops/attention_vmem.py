"""Mid-length attention with the whole score row on chip, PyTorch port.

Counterpart of ``deepearth_tpu/ops/attention_vmem.py``. For 256 <= Nk <= 1024
keys the (Nq, Nk) scores of one (batch row, head) fit on chip, so the score
matrix never has to reach device memory. :func:`dot_product_attention`
routes such shapes here for CUDA tensors, as the JAX package routes them to
its Pallas kernel on the TPU.

:func:`vmem_attention` is a ``torch.autograd.Function``: for a CUDA tensor
the forward is the hand-written kernel K3-fwd
(``kernels/csrc/attention_vmem.cu``), for a CPU tensor its plain PyTorch
version :func:`vmem_attention_plain`. The backward kernel K3-bwd is not
ported yet: on the card the backward raises; on the CPU it differentiates
the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
MAX_SEQ = kernels.VMEM_MAX_SEQ

K3_BWD_TODO = (
    "the K3 backward kernel (K3-bwd, attention_vmem.py _bwd_kernel) is not "
    "ported yet (ROADMAP.md Queue 2, K3-bwd, with the multimodal train step)")


def supported(nq: int, nk: int, dh: int, dv: int, is_causal: bool,
              has_bias: bool) -> bool:
    """Shape gate of ``dot_product_attention``'s router (the JAX package's
    truth table)."""
    return (not is_causal and not has_bias
            and 256 <= nk <= MAX_SEQ and nq <= MAX_SEQ
            and dh <= kernels.VMEM_MAX_DIM and dv <= kernels.VMEM_MAX_DIM)


def vmem_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float,
                         key_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of K3-fwd (any device, differentiable): fp32
    scores plus an additive 0 / NEG_BIG key mask, the guarded softmax
    (m >= -1e30, l >= 1e-30, so an all-masked row gives zeros), the
    probabilities rounded to v's dtype, then P.V in fp32, rounded once to
    q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        bias = torch.where(key_mask, 0.0, NEG_BIG).to(torch.float32)
        s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = (p / l).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


class _VmemAttention(torch.autograd.Function):
    """K3-fwd for CUDA tensors, its plain version for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.scale = scale
        if q.device.type == "cpu":
            return vmem_attention_plain(q, k, v, scale=scale,
                                        key_mask=key_mask)
        return kernels.vmem_attention_fwd(q, k, v, scale, key_mask)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask = ctx.saved_tensors
        if q.device.type != "cpu":
            raise NotImplementedError(K3_BWD_TODO)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = vmem_attention_plain(*leaves, scale=ctx.scale,
                                       key_mask=key_mask)
            dq, dk, dv = torch.autograd.grad(out, leaves, dout)
        return dq, dk, dv, None, None


def vmem_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, key_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Non-causal multi-head attention, the JAX package's layout.

    Args:
        q: (B, H, Nq, Dqk); k: (B, H, Nk, Dqk); v: (B, H, Nk, Dv).
        key_mask: optional (B, Nk) bool, False = masked out.

    Returns (B, H, Nq, Dv) in q's dtype; the softmax runs in fp32.
    """
    return _VmemAttention.apply(q, k, v, key_mask, float(scale))
