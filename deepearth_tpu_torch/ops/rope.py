"""Rotary position embeddings, PyTorch port of ``deepearth_tpu/ops/rope.py``:
base, linear, dynamic-NTK and YaRN scaling, and the three conventions.

* ``interleaved``: pairs ``(x[2i], x[2i+1])`` rotate together.
* ``half``: rotate_half on a half-split layout.
* ``deepseek``: MLA's variant, de-interleave ``(..., d)`` into the half
  layout, then rotate_half.

The tables are fp32 and computed with the JAX package's fp32 operations in
the same order. :func:`rope_tables` caches them per shape and device, so a
model's forward computes each table once.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import RopeScalingConfig


def rope_inv_freq(dim: int, theta: float = 10000.0, device=None
                  ) -> torch.Tensor:
    """Base inverse frequencies, shape (dim/2,), fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def yarn_find_correction_dim(num_rotations: float, dim: int, base: float,
                             max_pos: int) -> float:
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot: float, high_rot: float, dim: int,
                               base: float, max_pos: int) -> Tuple[int, int]:
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_pos))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_pos))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_linear_ramp(lo: float, hi: float, n: int, device=None
                      ) -> torch.Tensor:
    if lo == hi:
        hi += 0.001
    ramp = (torch.arange(n, dtype=torch.float32, device=device) - lo) / (
        hi - lo)
    return ramp.clamp(0.0, 1.0)


def rope_cos_sin(seq_len: int, dim: int, theta: float = 10000.0,
                 scaling: Optional[RopeScalingConfig] = None,
                 layout: str = "half", device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables of shape (seq_len, dim) [half layout] or
    (seq_len, dim/2) [interleaved layout], positions 0..seq_len-1.

    scaling.type: 'none'; 'linear' (positions divided by the factor);
    'dynamic' (NTK-aware base rescale past the original window); 'yarn'
    (per-dim interpolation ramp, tables scaled by the attention mscale).
    """
    scaling = scaling or RopeScalingConfig()
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    mscale = 1.0
    if scaling.type == "none":
        inv_freq = rope_inv_freq(dim, theta, device)
    elif scaling.type == "linear":
        inv_freq = rope_inv_freq(dim, theta, device)
        t = t / scaling.factor
    elif scaling.type == "dynamic":
        base = theta
        max_pos = scaling.original_max_position_embeddings
        if seq_len > max_pos:
            base = theta * ((scaling.factor * seq_len / max_pos)
                            - (scaling.factor - 1)) ** (dim / (dim - 2))
        inv_freq = rope_inv_freq(dim, base, device)
    elif scaling.type == "yarn":
        freq_extra = rope_inv_freq(dim, theta, device)
        freq_inter = freq_extra / scaling.factor
        lo, hi = yarn_find_correction_range(
            scaling.beta_fast, scaling.beta_slow, dim, theta,
            scaling.original_max_position_embeddings)
        extra_mask = 1.0 - _yarn_linear_ramp(lo, hi, dim // 2, device)
        inv_freq = freq_inter * (1.0 - extra_mask) + freq_extra * extra_mask
        mscale = (yarn_get_mscale(scaling.factor, scaling.mscale)
                  / yarn_get_mscale(scaling.factor, scaling.mscale_all_dim))
    else:
        raise ValueError(f"unknown rope scaling type {scaling.type!r}")

    freqs = torch.outer(t, inv_freq)  # (seq, dim/2)
    if layout == "half":
        emb = torch.cat([freqs, freqs], dim=-1)
    elif layout == "interleaved":
        emb = freqs
    else:
        raise ValueError(f"unknown rope layout {layout!r}")
    # cos and sin of the fp32 angles taken in float64 by numpy on the host
    # and rounded once to fp32, then scaled in fp32 as JAX scales its fp32
    # cos and sin. On the CPU, torch's first threaded cos of a process now
    # and then keeps only about half the mantissa (~1.5e-4 off at fp32),
    # and in float64 it may still land an fp32 ulp away from the next
    # call's; numpy's single-threaded cos gives the same bits every call.
    angles = emb.double().cpu().numpy()
    return tuple(torch.from_numpy(fn(angles)).to(emb.device).float() * mscale
                 for fn in (np.cos, np.sin))


@functools.lru_cache(maxsize=64)
def _cached_tables(seq_len, dim, theta, scaling_fields, layout, device):
    scaling = RopeScalingConfig(*scaling_fields)
    # made outside inference mode, so that a cached table also serves autograd
    with torch.inference_mode(False):
        return rope_cos_sin(seq_len, dim, theta, scaling, layout, device)


def rope_tables(seq_len: int, dim: int, theta: float = 10000.0,
                scaling: Optional[RopeScalingConfig] = None,
                layout: str = "half", device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rope_cos_sin`, cached per (shape, scaling, layout, device)."""
    fields = dataclasses.astuple(scaling or RopeScalingConfig())
    return _cached_tables(seq_len, dim, float(theta), fields, layout,
                          torch.device(device or "cpu"))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat([-x2, x1], dim=-1)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                    ) -> torch.Tensor:
    """rotate_half convention. x: (..., seq, dim); cos/sin: (seq, dim)."""
    return x * cos + rotate_half(x) * sin


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """Complex-pair convention. x: (..., seq, dim) with pairs
    (x[2i], x[2i+1]); cos/sin: (seq, dim/2)."""
    x_even, x_odd = x[..., 0::2], x[..., 1::2]
    out_even = x_even * cos - x_odd * sin
    out_odd = x_even * sin + x_odd * cos
    return torch.stack([out_even, out_odd], dim=-1).reshape(
        *out_even.shape[:-1], x.shape[-1])


def apply_rope_deepseek(x: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor) -> torch.Tensor:
    """MLA convention: de-interleave to the half layout, then rotate_half.
    x: (..., seq, dim); cos/sin: (seq, dim)."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(
        *x.shape[:-1], d)
    return x * cos + rotate_half(x) * sin
