"""Dense pre-norm transformer with RoPE, PyTorch port of
``deepearth_tpu/models/transformer.py``: ``KernelParam``, ``MLP`` and
``GatedMLP`` (also the fusion stack's), ``MultiHeadAttention``,
``TransformerBlock`` and ``Transformer`` (the A-stack's modality encoder),
with the JAX package's dropout sites.

Attention goes through ``ops.attention.dot_product_attention``: on the card
256-1024 keys with heads up to 128 wide take the kernels K3, as the JAX
package takes its Pallas kernel there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import TransformerConfig
from ..ops.attention import dot_product_attention
from ..ops.rope import apply_rope_half, apply_rope_interleaved, rope_tables
from .layers import Dense, Init, LayerNorm, dropout


class KernelParam(nn.Module):
    """A bias-free projection weight, stored (out, in), that the caller
    concatenates with others into one matmul (q/k/v, gate/up)."""

    def __init__(self, d_in: int, d_out: int, init: Init):
        super().__init__()
        self.weight = init.normal((d_out, d_in), 0.02)

    def forward(self) -> torch.Tensor:
        return self.weight


class MLP(nn.Module):
    """GELU MLP: fc1 -> exact GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, cfg: TransformerConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        hidden = int(cfg.hidden_dim * cfg.mlp_ratio)
        self.p = cfg.dropout
        self.fc1 = Dense(cfg.hidden_dim, hidden, init, compute_dtype, std=0.02)
        self.fc2 = Dense(hidden, cfg.hidden_dim, init, compute_dtype, std=0.02)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.gelu(self.fc1(x)), self.p, self.training, generator)
        return dropout(self.fc2(h), self.p, self.training, generator)


class GatedMLP(nn.Module):
    """SiLU-gated MLP: (silu(x Wg) * x Wu) Wd, gate and up as one matmul,
    then dropout."""

    def __init__(self, hidden_dim: int, mlp_ratio: float, init: Init,
                 compute_dtype: torch.dtype, dropout: float = 0.0):
        super().__init__()
        inner = int(hidden_dim * mlp_ratio)
        self.compute_dtype = compute_dtype
        self.p = dropout
        self.gate_proj = KernelParam(hidden_dim, inner, init)
        self.up_proj = KernelParam(hidden_dim, inner, init)
        self.down_proj = KernelParam(inner, hidden_dim, init)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cd = self.compute_dtype
        w_gu = torch.cat([self.gate_proj(), self.up_proj()]).to(cd)
        gate, up = F.linear(x.to(cd), w_gu).chunk(2, dim=-1)
        out = F.linear(F.silu(gate) * up, self.down_proj().to(cd))
        return dropout(out, self.p, self.training, generator)


class MultiHeadAttention(nn.Module):
    """RoPE multi-head self-attention: q, k, v in one matmul over the
    concatenated ``KernelParam``s, RoPE interleaved or rotate-half as
    ``cfg.rope_variant`` says (``cfg.use_rope``), attention with an optional
    (B, N) key mask, ``out_proj``, then dropout (``cfg.dropout``)."""

    def __init__(self, cfg: TransformerConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        D = cfg.hidden_dim
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, KernelParam(D, D, init))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, N, D); mask optional (B, N) bool, True = a visible key."""
        cfg, cd = self.cfg, self.compute_dtype
        B, N, D = x.shape
        H, Dh = cfg.n_heads, cfg.head_dim
        w = torch.cat([self.q_proj(), self.k_proj(), self.v_proj()]).to(cd)
        q, k, v = (t.view(B, N, H, Dh).transpose(1, 2)
                   for t in F.linear(x.to(cd), w).chunk(3, dim=-1))
        if cfg.use_rope:
            interleaved = cfg.rope_variant == "interleaved"
            cos, sin = rope_tables(
                N, Dh, cfg.rope_theta, device=x.device,
                layout="interleaved" if interleaved else "half")
            rope = apply_rope_interleaved if interleaved else apply_rope_half
            q = rope(q, cos, sin).to(q.dtype)
            k = rope(k, cos, sin).to(k.dtype)
        out = dot_product_attention(q, k, v, scale=Dh ** -0.5, key_mask=mask)
        out = F.linear(out.transpose(1, 2).reshape(B, N, D),
                       self.out_proj().to(cd))
        return dropout(out, cfg.dropout, self.training, generator)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attention(norm1(x)), then x + mlp(norm2(x)), the
    MLP GELU or (``cfg.use_gated_mlp``) SiLU-gated; LayerNorm eps
    ``cfg.layer_norm_eps``."""

    def __init__(self, cfg: TransformerConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        D, eps, cd = cfg.hidden_dim, cfg.layer_norm_eps, compute_dtype
        self.norm1 = LayerNorm(D, eps, init, cd)
        self.attention = MultiHeadAttention(cfg, init, cd)
        self.norm2 = LayerNorm(D, eps, init, cd)
        self.mlp = (GatedMLP(D, cfg.mlp_ratio, init, cd, cfg.dropout)
                    if cfg.use_gated_mlp else MLP(cfg, init, cd))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attention(self.norm1(x), mask, generator)
        return x + self.mlp(self.norm2(x), generator)


class Transformer(nn.Module):
    """``cfg.n_layers`` pre-norm blocks (``block_{i}``) and a final
    LayerNorm."""

    def __init__(self, cfg: TransformerConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.n_layers = cfg.n_layers
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", TransformerBlock(cfg, init,
                                                           compute_dtype))
        self.final_norm = LayerNorm(cfg.hidden_dim, cfg.layer_norm_eps, init,
                                    compute_dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, N, hidden_dim); mask optional (B, N) bool key mask."""
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, mask, generator)
        return self.final_norm(x)
