"""Grouped matmul over expert-sorted rows, the PyTorch port of the megablox
``gmm`` kernel that ``deepearth_tpu/ops/moe.py`` ``ragged_expert_ffn`` calls
on the TPU, and of its VJP.

:func:`gmm` is a ``torch.autograd.Function``. For CUDA tensors its forward
is the hand-written kernel K5-fwd (``kernels.grouped_matmul_fwd``: wgmma
over TMA tiles, ``kernels/csrc/grouped_matmul_tma.cu``, where
``kernels.gmm_fwd_tma_route`` holds; else ``kernels/csrc/grouped_matmul.cu``)
and its backward K5-bwd (``kernels.grouped_matmul_bwd``): megablox's ``gmm``
with ``transpose_rhs`` for dlhs and ``tgmm`` for drhs, one launch each, only
for the inputs that need a gradient. Where ``kernels.gmm_bwd_tma_route``
holds (bf16, K and N multiples of 8, as the flagship's 2048 x 2048 experts
are), fp32 dout is split once into bf16 hi + lo
(``grouped_matmul_split_dout``) and both gradients read the parts through
TMA into wgmma (``kernels/csrc/grouped_matmul_bwd_tma.cu``); other shapes
take ``kernels/csrc/grouped_matmul_bwd.cu``. For CPU tensors the plain
PyTorch versions :func:`gmm_plain`, :func:`gmm_bwd_plain` and
:func:`split_dout_plain` run. The group
sizes stay on the device: the kernels read them themselves, so a MoE layer
costs no host synchronisation, forward or backward.

What the port does not copy from the JAX call site: the 128-row padding of
the sorted rows into the last group and the tile table; the kernel takes any
M and any group sizes.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import remat

def supported(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> bool:
    """Inputs the kernel takes: lhs (M, K) and rhs (E, K, N) of one type,
    float32 or bfloat16, group_sizes (E,) int32 with 1 <= E <= 1024."""
    return (lhs.dim() == 2 and rhs.dim() == 3
            and rhs.shape[1] == lhs.shape[1]
            and lhs.dtype in (torch.float32, torch.bfloat16)
            and rhs.dtype == lhs.dtype and group_sizes.dtype == torch.int32
            and tuple(group_sizes.shape) == (rhs.shape[0],)
            and 1 <= rhs.shape[0] <= kernels.GMM_MAX_GROUPS)


def _segments(group_sizes: torch.Tensor, m: int):
    """(group, first row, end row) of each non-empty group, cut at M. Reads
    the sizes on the host: the plain versions only."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(size, 0), m)
        if end > start:
            yield g, start, end
        start = end


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5-fwd: for each group g, rows
    [offset_g, offset_g + size_g) of lhs times rhs[g] in fp32 (a bf16.bf16
    product is exact in fp32, so each sum rounds only where the kernel's
    does); rows past the sum of the sizes are 0. Returns (M, N) float32."""
    m = lhs.shape[0]
    out = torch.zeros((m, rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    for g, start, end in _segments(group_sizes, m):
        out[start:end] = lhs[start:end].float() @ rhs[g].float()
    return out


def gmm_bwd_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                  group_sizes: torch.Tensor, dout: torch.Tensor,
                  need_lhs: bool = True, need_rhs: bool = True):
    """Plain PyTorch version of K5-bwd (megablox ``_gmm_bwd``): dlhs rows of
    group g = dout rows . rhs[g]^T, rounded to lhs's type (rows past the
    last group 0); drhs[g] = lhs rows^T . dout rows, rounded to rhs's type
    (0 for an empty group); fp32 sums. Returns (dlhs, drhs), each None when
    not needed."""
    dout = dout.float()
    dlhs = (torch.zeros(lhs.shape, dtype=torch.float32, device=lhs.device)
            if need_lhs else None)
    drhs = (torch.zeros(rhs.shape, dtype=torch.float32, device=rhs.device)
            if need_rhs else None)
    for g, start, end in _segments(group_sizes, lhs.shape[0]):
        if need_lhs:
            dlhs[start:end] = dout[start:end] @ rhs[g].float().T
        if need_rhs:
            drhs[g] = lhs[start:end].float().T @ dout[start:end]
    return (None if dlhs is None else dlhs.to(lhs.dtype),
            None if drhs is None else drhs.to(rhs.dtype))


def split_dout_plain(dout: torch.Tensor):
    """Plain PyTorch version of K5-bwd's split: (hi, lo) of fp32 dout, two
    bfloat16 tensors of its shape, hi = bf16(x) and lo = bf16(x - hi), each
    rounded to nearest even."""
    dout = dout.float()
    hi = dout.to(torch.bfloat16)
    return hi, (dout - hi.float()).to(torch.bfloat16)


class _GroupedMatmul(torch.autograd.Function):
    """K5-fwd and K5-bwd for CUDA tensors, the plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        with remat.kernel_site():
            if lhs.device.type == "cpu":
                return gmm_plain(lhs, rhs, group_sizes)
            return kernels.grouped_matmul_fwd(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        need_lhs, need_rhs = ctx.needs_input_grad[:2]
        if lhs.device.type == "cpu":
            return (*gmm_bwd_plain(lhs, rhs, group_sizes, dout, need_lhs,
                                   need_rhs), None)
        return (*kernels.grouped_matmul_bwd(lhs, rhs, group_sizes, dout,
                                            need_lhs, need_rhs), None)


def gmm(lhs: torch.Tensor, rhs: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped matmul, megablox's ``gmm`` with fp32 output.

    Args:
        lhs: (M, K) rows sorted by group, float32 or bfloat16.
        rhs: (E, K, N), lhs's type.
        group_sizes: (E,) int32, on lhs's device; group g holds rows
            [sum of sizes before g, + size_g).

    Returns (M, N) float32: row r of group g is lhs[r] . rhs[g].
    """
    return _GroupedMatmul.apply(lhs, rhs, group_sizes)
