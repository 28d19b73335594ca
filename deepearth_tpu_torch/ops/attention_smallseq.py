"""Token-major attention for tiny static sequences, PyTorch port.

Counterpart of ``deepearth_tpu/ops/attention_smallseq.py``. The fusion
stack's few universal tokens run token-major, (N, B, D) with D = H * Dh, and
every attention site is a softmax over the Nk keys of each (query, batch
row, head).

:func:`pairwise_token_attention` dispatches on the device of its input: a
CUDA tensor goes to the hand-written kernel
(``kernels/csrc/pairwise_attention.cu``), a CPU tensor to
:func:`pairwise_token_attention_plain`, the plain PyTorch version.
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


def pairwise_token_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_heads: int,
    scale: float, key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`pairwise_token_attention` (any device)."""
    nq, b, d = q.shape
    nk = k.shape[0]
    dh = d // n_heads
    qf = q.float().reshape(nq, b, n_heads, dh)
    kf = k.float().reshape(nk, b, n_heads, dh)
    vf = v.float().reshape(nk, b, n_heads, dh)
    scores = torch.einsum("ibhd,jbhd->ijbh", qf, kf) * scale  # (Nq, Nk, B, H)
    if key_mask is not None:
        scores = torch.where(key_mask.T[None, :, :, None], scores,
                             torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=1, keepdim=True)
    out = torch.einsum("ijbh,jbhd->ibhd", probs, vf).reshape(nq, b, d)
    if key_mask is not None:
        # a query with no visible key outputs zero
        out = torch.where(key_mask.any(dim=1)[None, :, None], out,
                          torch.zeros_like(out))
    return out.to(q.dtype)


def pairwise_token_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_heads: int,
    scale: float, key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention, token-major, tiny static N.

    Args:
        q: (Nq, B, D); k, v: (Nk, B, D), flat head layout D = H * Dh.
        key_mask: optional (B, Nk) bool, True = visible.

    Returns (Nq, B, D) in q's dtype; the softmax runs in float32.
    """
    if q.device.type == "cpu":
        return pairwise_token_attention_plain(
            q, k, v, n_heads=n_heads, scale=scale, key_mask=key_mask)
    return kernels.pairwise_attention_fwd(q, k, v, n_heads, scale, key_mask)
