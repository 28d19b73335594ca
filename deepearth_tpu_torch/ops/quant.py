"""Weight-only int8 and int4 quantization and the fused-dequant batched
matmul, PyTorch port of ``deepearth_tpu/ops/quant.py``.

A small-batch decode step is bound by the weight bytes it streams, so the
decode path keeps its large matmul weights as int8 (or two int4 values per
byte) with one fp32 scale per output column, and widens them inside the
kernel: device memory only ever sees the quantized bytes.

The stored format is the JAX package's, so that a tree it quantized loads
and computes the same:

* weights (..., D, Fp), the reduction dim first (as flax stores kernels),
  int8, the columns padded with zeros to a multiple of 128;
* int4 in the split-half layout (..., D/2, Fp): byte i holds row i in its
  low nibble and row i + D/2 in its high nibble, both signed;
* scale float32 (..., 1, F), unpadded, absmax / 127 (int8) or / 7 (int4).

:func:`int8_bmm` and :func:`int4_bmm` run the hand-written kernels K6
and K7 (tensor cores in one cluster launch,
``kernels/csrc/quant_matmul_tc.cu``, where ``kernels.int8_bmm_tc_route`` /
``kernels.int4_bmm_tc_route`` holds, as at every decode shape; else
``quant_matmul.cu``'s CUDA cores) on a CUDA tensor and their plain
PyTorch versions on a CPU tensor. Where the JAX package leaves its Pallas
kernel for an einsum over the dequantized weights (shapes its tiles do not
fit), both devices take that einsum too, so the two packages round alike.
What is not ported: the TPU tile tables and the 16-row padding of x.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels

_PAD_COLS = 128
# the JAX package's VMEM budget for one tile (quant.py _pick_tiles)
_VMEM_BUDGET = 13 * 2 ** 20


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _tiles_fit(rows: int, fp: int, c: int, int4: bool) -> bool:
    """Whether the JAX package's ``_pick_tiles`` finds a tile for a
    reduction of ``rows`` (D, or D/2 packed), Fp columns and C rows of x
    (padded to 16). Its candidates are multiples of 128 and its VMEM
    estimate grows with both tile sides, so a tile exists iff the smallest,
    128 x 128, divides the shape and fits the budget."""
    if rows % 128 or fp % 128:
        return False
    cp = max(_round_up(c, 16), 16)
    if int4:
        vmem = 6 * 128 * 128 + 8 * cp * 128 + 6 * cp * 128
    else:
        vmem = 4 * 128 * 128 + 4 * cp * 128 + 6 * cp * 128
    return vmem <= _VMEM_BUDGET


# --------------------------------------------------------------------------- #
# quantization
# --------------------------------------------------------------------------- #

def _pad_cols(q: torch.Tensor) -> torch.Tensor:
    f = q.shape[-1]
    return F.pad(q, (0, _round_up(f, _PAD_COLS) - f))


def quantize_int8(w: torch.Tensor):
    """Symmetric per-output-column int8 quantization of (..., D, F) weights.
    Returns (w_q int8 (..., D, Fp), scale float32 (..., 1, F)), bit for bit
    the JAX package's."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return _pad_cols(q), scale


def quantize_int4(w: torch.Tensor):
    """Symmetric per-output-column int4 quantization of (..., D, F) weights,
    packed in the split-half layout: (w_p int8 (..., D/2, Fp), scale
    float32 (..., 1, F) = absmax / 7). D must be even."""
    d = w.shape[-2]
    if d % 2:
        raise ValueError(f"int4 packing needs even reduction dim, got {d}")
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 7.0
    q = torch.round(wf / scale).clamp(-7, 7).to(torch.int32)
    lo, hi = q[..., : d // 2, :], q[..., d // 2:, :]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    return _pad_cols(packed), scale


def dequantize(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 (..., D, F): the inverse of :func:`quantize_int8`."""
    return w_q[..., : scale.shape[-1]].float() * scale


def _unpack_int4(w_p: torch.Tensor):
    """(..., D/2, Fp) packed bytes -> sign-extended (lo, hi) int32 nibbles."""
    wi = w_p.to(torch.int32)
    return (wi << 28) >> 28, wi >> 4


def dequantize_int4(w_p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 (..., D, F): the inverse of :func:`quantize_int4`."""
    lo, hi = _unpack_int4(w_p)
    q = torch.cat([lo, hi], dim=-2)[..., : scale.shape[-1]]
    return q.float() * scale


# --------------------------------------------------------------------------- #
# the fused-dequant batched matmul: K6, K7 and their plain versions
# --------------------------------------------------------------------------- #

def _einsum_route(x, w, out_dtype):
    return torch.einsum("ecd,edf->ecf", x, w.to(x.dtype)).to(out_dtype)


def int8_bmm_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K6: x rounded to bf16, the int8 weights
    widened, both to fp32 (every product is exact there), summed at fp32,
    times the scale once, cast to ``out_dtype``."""
    xb = x.to(torch.bfloat16).float()
    y = xb @ w_q[..., : scale.shape[-1]].float()
    return (y * scale.float()).to(out_dtype)


def int4_bmm_plain(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K7: as :func:`int8_bmm_plain` over the
    split-half nibbles, the low ones against x[..., :D/2], the high ones
    against x[..., D/2:]."""
    f = scale.shape[-1]
    lo, hi = _unpack_int4(w_p[..., :f])
    xb = x.to(torch.bfloat16).float()
    dh = lo.shape[-2]
    y = xb[..., :dh] @ lo.float() + xb[..., dh:] @ hi.float()
    return (y * scale.float()).to(out_dtype)


def int8_bmm(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Batched ``x @ dequant(w_q)``: (E, C, D) x (E, D, Fp) -> (E, C, F).

    Where the JAX package's tiles fit (D and Fp multiples of 128, C within
    the VMEM budget), K6 on a CUDA tensor and :func:`int8_bmm_plain` on a
    CPU tensor; elsewhere, on either, an einsum in x's type over the
    dequantized weights, as the JAX package falls back."""
    e, c, d = x.shape
    if not _tiles_fit(d, w_q.shape[-1], c, int4=False):
        return _einsum_route(x, dequantize(w_q, scale), out_dtype)
    if x.is_cuda:
        return kernels.int8_bmm(x, w_q, scale, out_dtype)
    return int8_bmm_plain(x, w_q, scale, out_dtype)


def int4_bmm(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Batched ``x @ dequant(w_p)`` over split-half int4 weights:
    (E, C, D) x (E, D/2, Fp) -> (E, C, F). K7 on a CUDA tensor,
    :func:`int4_bmm_plain` on a CPU tensor, and the JAX package's einsum
    route where its tiles do not fit (D odd, w_p not D/2 rows, D/2 or Fp
    not a multiple of 128, or C beyond the budget)."""
    e, c, d = x.shape
    dh = d // 2
    if d % 2 or w_p.shape[-2] != dh or not _tiles_fit(
            dh, w_p.shape[-1], c, int4=True):
        return _einsum_route(x, dequantize_int4(w_p, scale), out_dtype)
    if x.is_cuda:
        return kernels.int4_bmm(x, w_p, scale, out_dtype)
    return int4_bmm_plain(x, w_p, scale, out_dtype)


def _matmul(bmm, x, w, scale, out_dtype):
    lead, d = x.shape[:-1], x.shape[-1]
    y = bmm(x.reshape(1, -1, d), w[None], scale[None], out_dtype)
    return y.reshape(*lead, y.shape[-1])


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ dequant(w_q)`` for 2-D weights; x may have any leading dims."""
    return _matmul(int8_bmm, x, w_q, scale, out_dtype)


def int4_matmul(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ dequant(w_p)`` for 2-D int4-packed weights; any leading dims."""
    return _matmul(int4_bmm, x, w_p, scale, out_dtype)


# --------------------------------------------------------------------------- #
# the quantized model and the decode path's apply helpers
# --------------------------------------------------------------------------- #

def _frozen(t: torch.Tensor) -> nn.Parameter:
    # held as parameters, so that convert and the byte count see them like
    # every other leaf; an int8 parameter cannot require a gradient anyway
    return nn.Parameter(t, requires_grad=False)


class QuantDense(nn.Module):
    """A quantized ``Dense``: ``kernel_q`` (D, Fp) int8 or ``kernel_q4``
    (D/2, Fp) packed int4, ``scale`` (1, F) float32 and the layer's bias,
    under the JAX package's leaf names. Its forward is :func:`linear_p`."""

    def __init__(self, kernel: torch.Tensor, scale: torch.Tensor,
                 bias, int4: bool):
        super().__init__()
        setattr(self, "kernel_q4" if int4 else "kernel_q", _frozen(kernel))
        self.scale = _frozen(scale)
        self.bias = bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_p(self, x)


_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
# kv_b_proj is reshaped into per-head W_k / W_v for projection absorption
# (models/mla_decode.py) and never feeds a plain matmul, so it stays as it is
_SKIP_NAMES = frozenset({"kv_b_proj"})


def quantize_decoder_params(model: nn.Module, min_dim: int = 256,
                            bits: int = 8) -> nn.Module:
    """A quantized copy of a ``DeepSeekForCausalLM``, by the JAX package's
    rules: a ``Dense`` (other than ``kv_b_proj``) whose smaller dim is at
    least ``min_dim`` and whose input dim is a multiple of 128 becomes a
    :class:`QuantDense`; an ``MoELayer``'s expert weights that pass the same
    test on (D, F) become ``w_*_q`` / ``w_*_q4`` and ``w_*_scale``.
    Embeddings, norms, the router and biases stay as they are. With
    ``bits=4`` a weight whose reduction dim is not a multiple of 256 falls
    back to int8, so a model may mix the two."""
    from ..models.deepseek import MoELayer
    from ..models.layers import Dense

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant_one(w):  # w in the JAX layout (..., D, F)
        if bits == 4 and w.shape[-2] % 256 == 0:
            return (*quantize_int4(w), True)
        return (*quantize_int8(w), False)

    def fits(w):  # (..., D, F)
        return min(w.shape[-2:]) >= min_dim and w.shape[-2] % 128 == 0

    out = copy.deepcopy(model)
    with torch.no_grad():
        for parent in list(out.modules()):
            for name, child in list(parent.named_children()):
                if (isinstance(child, Dense) and name not in _SKIP_NAMES
                        and fits(child.weight.T)):
                    q, s, int4 = quant_one(child.weight.T)
                    setattr(parent, name, QuantDense(q, s, child.bias, int4))
            if isinstance(parent, MoELayer):
                for key in _EXPERT_KEYS:
                    w = getattr(parent, key)
                    if w.dim() == 3 and fits(w):
                        q, s, int4 = quant_one(w)
                        delattr(parent, key)
                        setattr(parent, key + ("_q4" if int4 else "_q"),
                                _frozen(q))
                        setattr(parent, key + "_scale", _frozen(s))
    return out


def _add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    return y if bias is None else y + bias


def linear_p(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A dense layer over plain, int8 or int4 weights, in the JAX package's
    types: a quantized layer gives x's type; a plain one ``x @ kernel`` in
    the promoted type of x and the weight (then the bias added)."""
    if hasattr(layer, "kernel_q4"):
        y = int4_matmul(x, layer.kernel_q4, layer.scale, out_dtype=x.dtype)
    elif hasattr(layer, "kernel_q"):
        y = int8_matmul(x, layer.kernel_q, layer.scale, out_dtype=x.dtype)
    else:
        dt = torch.promote_types(x.dtype, layer.weight.dtype)
        y = F.linear(x.to(dt), layer.weight.to(dt))
    return _add_bias(y, layer.bias)


def _bmm_p(layer: nn.Module, key: str, x: torch.Tensor) -> torch.Tensor:
    scale = getattr(layer, key + "_scale")
    if hasattr(layer, key + "_q4"):
        return int4_bmm(x, getattr(layer, key + "_q4"), scale,
                        out_dtype=x.dtype)
    return int8_bmm(x, getattr(layer, key + "_q"), scale, out_dtype=x.dtype)


def expert_ffn_q(layer: nn.Module, expert_in: torch.Tensor) -> torch.Tensor:
    """Batched SwiGLU experts over an ``MoELayer``'s int8 / int4 weights:
    expert_in (E, C, D) -> (E, C, D) in its type (the decode path's twin of
    ``ops.moe.expert_ffn``)."""
    gate = _bmm_p(layer, "w_gate", expert_in)
    up = _bmm_p(layer, "w_up", expert_in)
    return _bmm_p(layer, "w_down", F.silu(gate) * up)


def is_quantized_moe(layer: nn.Module) -> bool:
    return hasattr(layer, "w_gate_q") or hasattr(layer, "w_gate_q4")


def quantized_bytes(model: nn.Module) -> Dict[str, int]:
    """Weight bytes: the whole model's (every parameter) and those of its
    quantized weights (leaves named ``*_q*``), as the JAX package counts a
    tree."""
    tot = q = 0
    for name, p in model.named_parameters():
        n = p.numel() * p.element_size()
        tot += n
        if "_q" in name.rsplit(".", 1)[-1]:
            q += n
    return {"total_bytes": int(tot), "int8_bytes": int(q)}


__all__ = [
    "quantize_int8", "quantize_int4", "dequantize", "dequantize_int4",
    "int8_bmm", "int4_bmm", "int8_bmm_plain", "int4_bmm_plain",
    "int8_matmul", "int4_matmul", "QuantDense", "quantize_decoder_params",
    "linear_p", "expert_ffn_q", "is_quantized_moe", "quantized_bytes",
]
