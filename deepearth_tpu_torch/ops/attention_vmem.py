"""Mid-length attention with the whole score row on chip, PyTorch port.

Counterpart of ``deepearth_tpu/ops/attention_vmem.py``. For 256 <= Nk <= 1024
keys the (Nq, Nk) scores of one (batch row, head) fit on chip, so the score
matrix never has to reach device memory. :func:`dot_product_attention`
routes such shapes here for CUDA tensors, as the JAX package routes them to
its Pallas kernel on the TPU.

:func:`vmem_attention` is a ``torch.autograd.Function``: for a CUDA tensor
the forward is the hand-written kernel K3-fwd (``kernels.vmem_attention_fwd``:
wgmma over TMA tiles with a stats sweep,
``kernels/csrc/attention_vmem_fwd_tma.cu``, where
``kernels.vmem_fwd_tma_route`` holds, as at the model's bf16 sites; else
``kernels/csrc/attention_vmem.cu``) and the backward K3-bwd
(``kernels.vmem_attention_bwd``: wgmma over TMA tiles,
``kernels/csrc/flash_attention_bwd_tma.cu``, where
``kernels.vmem_bwd_tma_route`` holds, as at the model's bf16 sites; else
``kernels/csrc/attention_vmem_bwd.cu``); for a CPU tensor their plain
PyTorch versions :func:`vmem_attention_plain` and
:func:`vmem_attention_bwd_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from . import remat

NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)
MAX_SEQ = kernels.VMEM_MAX_SEQ


def supported(nq: int, nk: int, dh: int, dv: int, is_causal: bool,
              has_bias: bool) -> bool:
    """Shape gate of ``dot_product_attention``'s router (the JAX package's
    truth table)."""
    return (not is_causal and not has_bias
            and 256 <= nk <= MAX_SEQ and nq <= MAX_SEQ
            and dh <= kernels.ATTN_MAX_DIM and dv <= kernels.ATTN_MAX_DIM)


def _probs(q, k, scale, key_mask):
    """fp32 scores plus the 0 / NEG_BIG key mask through the guarded
    softmax: (B, H, Nq, Nk) fp32 probabilities, a row of zeros where every
    key is masked."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        bias = torch.where(key_mask, 0.0, NEG_BIG).to(torch.float32)
        s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def vmem_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float,
                         key_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of K3-fwd (any device, differentiable): fp32
    scores plus an additive 0 / NEG_BIG key mask, the guarded softmax
    (m >= -1e30, l >= 1e-30, so an all-masked row gives zeros), the
    probabilities rounded to v's dtype, then P.V in fp32, rounded once to
    q's dtype."""
    p = _probs(q, k, scale, key_mask).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def vmem_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor, *,
                             scale: float,
                             key_mask: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K3-bwd, step by step the JAX package's
    ``_bwd_kernel``: p recomputed in fp32 with the guarded softmax;
    dv = (p -> dout's dtype)^T . dout; dp = dout . v^T in fp32;
    delta = rowsum(dp o p) from the fp32 p; ds = (p (dp - delta) scale) ->
    q's dtype; dq = ds . k; dk = ds^T . q. Each product sums in fp32 and
    rounds once. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    p = _probs(q, k, scale, key_mask)
    do = dout.float()
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _VmemAttention(torch.autograd.Function):
    """K3-fwd and K3-bwd for CUDA tensors, their plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.scale = scale
        with remat.kernel_site():
            if q.device.type == "cpu":
                return vmem_attention_plain(q, k, v, scale=scale,
                                            key_mask=key_mask)
            return kernels.vmem_attention_fwd(q, k, v, scale, key_mask)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = vmem_attention_bwd_plain(
                q, k, v, dout, scale=ctx.scale, key_mask=key_mask)
        else:
            dq, dk, dv = kernels.vmem_attention_bwd(q, k, v, dout, ctx.scale,
                                                    key_mask)
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
